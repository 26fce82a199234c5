"""The port's FFJORD against nf_tpu's, on the CPU.

nf_tpu draws its Hutchinson probes from JAX keys, the port from torch
generators, so every comparison hands the port nf_tpu's draw
(``CNF.injected_probes``): in eval ``normal(PRNGKey(0), (4,) + x.shape)``
for every CNF; in training ``normal(fold_in(step_key, i), (1,) + x.shape)``
for the CNF at chain index i, step_key = ``fold_in(PRNGKey(seed), step)``,
and the data-dependent init's ``fold_in(PRNGKey(seed), 1)``.

* ``ODENet`` (dense and conv, the time channel first) within 2e-5, and
  ``CNF`` forward / inverse in eval with the exact and the Hutchinson
  trace, in train mode with one probe, 2-D and 3x3x2 images: z and the
  log-det within 2e-5 (f32 rounding: measured 4.8e-7); in 2-D eval with
  Hutchinson's trace the dopri5 solve's dynamics evaluations equal
  nf_tpu's, counted under ``jax.disable_jit()``: the same steps;
* the model (2 layers, base_filters 16, stepsize 0.25, dopri5 at 1e-4)
  through ``convert.load_jax_variables``: ``EvalProgram`` log p within 1e-4
  of nf_tpu's, and the inverse of the latent within 1e-4;
* three ``Trainer`` steps against nf_tpu's (one layer, base_filters 8),
  at backprop 'adjoint' and 'normal': the first step's gradients within 1e-5 + 1e-5 relative of
  ``jax.grad`` (measured 3.3e-7 at |g| = 0.47), the losses within rtol
  1e-5 and the state after the steps within 1e-5 (measured 2.4e-7): no
  parameter of FFJORD sits ahead of a batch norm, so none is moved by
  rounding noise alone;
* the image opt-in at 8x8x1 (1 layer, base_filters 8): without
  ``allow_image`` it raises nf_tpu's message; with it, Logit first, then
  the conv ODENet (stepsize 0.5), log p within 3e-4 (image
  log-densities) and the inverse within 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import close, normal, to_numpy, uniform

from nf_tpu.bijectors import cnf as jcnf
from nf_tpu.config import NetworkConfig as JNetworkConfig
from nf_tpu.config import OptimizerConfig as JOptimizerConfig
from nf_tpu.core import Ctx
from nf_tpu_torch.bijectors import cnf as tcnf
from nf_tpu_torch.config import NetworkConfig, OptimizerConfig
from nf_tpu_torch.convert import load_jax_variables

EVAL = Ctx(rng=None, train=False)
TRAIN_KEY = jax.random.PRNGKey(7)
KW = dict(layers=2, base_filters=16, stepsize=0.25, solver="dopri5", rtol=1e-4, atol=1e-4)


def _t(a):
    return torch.from_numpy(np.array(a))


def eval_probes(shape):
    """nf_tpu's eval draw: every CNF keys on PRNGKey(0)."""
    return _t(jax.random.normal(jax.random.PRNGKey(0), (4,) + tuple(shape)))


def train_probes(key, i, shape):
    """nf_tpu's training draw for the CNF at chain index i."""
    return _t(jax.random.normal(jax.random.fold_in(key, i), (1,) + tuple(shape)))


def _cnfs(model):
    return [(i, m) for i, m in enumerate(model.bijector.layers) if isinstance(m, tcnf.CNF)]


@pytest.mark.parametrize("dims", [(3,), (4, 4, 2)], ids=["dense", "conv"])
def test_odenet_matches_nf_tpu(dims):
    jn = jcnf.ODENet(dims, base_filters=8)
    p = to_numpy(jn.init(jax.random.PRNGKey(1)))
    tn = tcnf.ODENet(dims, base_filters=8, device="cpu")
    tn.init(torch.Generator().manual_seed(0))
    bound = [float(w.detach().abs().max()) for w in tn.w]
    fan = [(d + 1) * (9 if len(dims) == 3 else 1) for d in tn.hidden[:-1]]
    assert all(b <= np.sqrt(1.0 / f) for b, f in zip(bound, fan))
    with torch.no_grad():
        for i, (w, b) in enumerate(zip(tn.w, tn.b)):
            w.copy_(_t(p["w"][i].transpose(3, 2, 0, 1) if len(dims) == 3 else p["w"][i]))
            b.copy_(_t(p["b"][i]))
    x = normal(3, (5,) + dims)
    with torch.no_grad():
        close(tn(0.375, _t(x)), jn.apply(p, jnp.float32(0.375), x), 2e-5)


def _cnf_pair(dims, trace, seed=2):
    times = np.linspace(0.0, 1.0, 5, dtype=np.float32)
    kw = dict(solver="dopri5", trace_estimator=trace, base_filters=8, rtol=1e-4, atol=1e-4)
    jc = jcnf.CNF(dims, times, **kw)
    var = to_numpy(jc.init(jax.random.PRNGKey(seed)))
    # weights scaled up so the solve takes several adaptive steps
    var["params"]["net"]["w"] = [w * 3.0 for w in var["params"]["net"]["w"]]
    tc = tcnf.CNF(dims, times, device="cpu", **kw)
    load_jax_variables(tc, var)
    return jc, var, tc


def _counted_jax(jc, var, x, direction, ctx, count):
    """nf_tpu's CNF, its dynamics evaluations counted under
    ``jax.disable_jit()`` when ``count``, else jitted (None counted)."""
    if not count:
        return jax.jit(lambda v, y: getattr(jc, direction)(v, y, ctx))(var, x), None
    calls = [0]
    dynamics = jc._dynamics

    def counted(n_probes, exact):
        fn = dynamics(n_probes, exact)

        def wrapped(pv, t, state):
            calls[0] += 1
            return fn(pv, t, state)

        return wrapped

    jc._dynamics = counted
    with jax.disable_jit():
        out = getattr(jc, direction)(var, x, ctx)
    return out, calls[0]


@pytest.mark.parametrize("dims", [(2,), (3, 3, 2)], ids=["2d", "image"])
@pytest.mark.parametrize("mode", ["exact", "hutchinson", "train"])
def test_cnf_matches_nf_tpu(dims, mode):
    jc, var, tc = _cnf_pair(dims, "exact" if mode == "exact" else "hutchinson")
    x = normal(4, (6,) + dims)
    ctx = EVAL
    if mode == "train":
        ctx = Ctx(rng=TRAIN_KEY, train=True)
        tc.injected_probes = _t(jax.random.normal(TRAIN_KEY, (1,) + x.shape))
        tc.train()
    else:
        tc.eval()
        if mode == "hutchinson":
            tc.injected_probes = eval_probes(x.shape)
    for direction in ("forward", "inverse"):
        count = mode == "hutchinson" and len(dims) == 1
        (jy, jld, _), calls = _counted_jax(jc, var, x, direction, ctx, count)
        tc.stats = tcnf.SolveStats()
        with torch.no_grad():
            y, ld = getattr(tc, direction)(_t(x))
        assert tc.stats.accepted > 1 and (not count or tc.stats.evaluations == calls)
        close(y, jy, 2e-5)
        close(ld, jld, 2e-5)


def test_cnf_rejects_unknown_options():
    with pytest.raises(ValueError, match="bosha3"):
        tcnf.CNF((2,), [0.0, 1.0], solver="euler", device="cpu")
    with pytest.raises(ValueError, match="backprop"):
        tcnf.CNF((2,), [0.0, 1.0], backprop="checkpoint", device="cpu")


def _jax_ffjord(dims, datatype, seed=0, **kw):
    from nf_tpu.models import build_model

    cfg = JNetworkConfig(name="ffjord", **{**KW, **kw})
    model = build_model("ffjord", dims, datatype=datatype, cfg=cfg)
    var = model.init(jax.random.PRNGKey(seed))
    return model, var


def _torch_ffjord(dims, datatype, var=None, **kw):
    from nf_tpu_torch.models import build_model

    model = build_model("ffjord", dims, datatype,
                        NetworkConfig(name="ffjord", **{**KW, **kw}), device="cpu")
    if var is not None:
        load_jax_variables(model, to_numpy(var))
    return model


def _program_parity(dims, datatype, x, logp_atol, **kw):
    jm, var = _jax_ffjord(dims, datatype, **kw)
    var = to_numpy(jm.data_dependent_init(var, x))
    tm = _torch_ffjord(dims, datatype, var, **kw)
    for _, m in _cnfs(tm):
        m.injected_probes = eval_probes(x.shape)
    jprog = jm.eval_program(var)
    prog = tm.eval_program()
    assert prog.stack is None
    close(prog.log_prob(_t(x)), jprog.log_prob(x), logp_atol)
    jz, _ = jprog.forward(x)
    xr, ld = prog.inverse(_t(np.asarray(jz)))
    jxr, jld = jprog.inverse(jz)
    close(xr, jxr, 1e-4)
    close(ld, jld, 1e-4)


def test_model_matches_nf_tpu():
    _program_parity((2,), "2d", normal(5, (32, 2)) * 1.3 + 0.2, 1e-4)


def test_image_opt_in_matches_nf_tpu():
    dims = (8, 8, 1)
    with pytest.raises(NotImplementedError, match="allow_image"):
        _torch_ffjord(dims, "image")
    kw = dict(layers=1, base_filters=8, stepsize=0.5, allow_image=True)
    tm = _torch_ffjord(dims, "image", **kw)
    kinds = [type(m).__name__ for m in tm.bijector.layers]
    assert kinds == ["Logit", "ActNorm", "CNF"] and tm.bijector.layers[2].net.is_image
    _program_parity(dims, "image", uniform(6, (8,) + dims), 3e-4, **kw)


@pytest.mark.parametrize("backprop", ["adjoint", "normal"])
def test_trainer_matches_nf_tpu(backprop):
    from nf_tpu.train import Trainer as JTrainer
    from nf_tpu_torch.train import Trainer

    B = 64
    batches = np.stack([normal(10 + k, (B, 2)) * 1.3 + 0.2 for k in range(4)])
    small = dict(layers=1, base_filters=8, backprop=backprop)
    jm, var0 = _jax_ffjord((2,), "2d", **small)
    key = jax.random.PRNGKey(0)
    jt = JTrainer(jm, JOptimizerConfig(), seed=0)
    jts = jt.init_state(key, batches[0])

    def loss(params, batch, rng):
        v = {"params": params, "state": jts.state}
        return -jm.log_prob(v, batch, Ctx(rng=rng, train=True))[0].mean()

    jgrads = jax.grad(loss)(jts.params, batches[1], jax.random.fold_in(key, 0))
    jlosses = []
    for k in range(1, 4):
        jts, lj = jt.train_step(jts, batches[k])
        jlosses.append(float(lj))

    tm = _torch_ffjord((2,), "2d", **small)
    cnfs = _cnfs(tm)
    tt = Trainer(tm, OptimizerConfig(), seed=0)
    dd_key = jax.random.fold_in(key, 1)
    for i, m in cnfs:
        m.injected_probes = train_probes(dd_key, i, (B, 2))
    ts = tt.init_state(torch.from_numpy(batches[0]),
                       params=load_jax_variables(tm, to_numpy(var0)))
    losses = []
    for k in range(1, 4):
        step_key = jax.random.fold_in(key, ts.step)
        for i, m in cnfs:
            m.injected_probes = train_probes(step_key, i, (B, 2))
        ts, lt = tt.train_step(ts, torch.from_numpy(batches[k]))
        losses.append(float(lt))
        if k == 1:
            want = _torch_ffjord((2,), "2d", to_numpy({"params": jgrads, "state": jts.state}),
                                 **small)
            want = dict(want.named_parameters())
            for name, p in tm.named_parameters():
                close(p.grad, want[name].detach(), 1e-5, 1e-5)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    ref = _torch_ffjord((2,), "2d", to_numpy(jts.var), **small).state_dict()
    for name, got in tm.state_dict().items():
        close(got.float(), ref[name].float(), 1e-5)
    assert all(m.stats.solves > 0 and m.stats.rejected == 0 for _, m in cnfs)
