"""Shared set-up of the port's parity tests: the same model built by
``nf_tpu`` (JAX, CPU) and by ``nf_tpu_torch`` (PyTorch, CPU), with the JAX
variables carried across, and inputs made with numpy."""
from __future__ import annotations

import jax
import numpy as np
import torch

torch.set_num_threads(1)


def to_numpy(var):
    return jax.tree.map(np.asarray, var)


def normal(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def jax_model(name: str, D: int, layers: int, filters: int, seed: int = 0,
              batch: int = 64, mixtures: int = 4, logdet: str = "unbias",
              spnorm_coeff: float = 0.9):
    """An nf_tpu density model after its data-dependent init (ActNorm; for
    ResFlow also one spectral-norm power iteration) and with any
    batch-norm running statistics moved off their init values (as
    tests/test_pallas.py does), so the folding of those statistics has
    teeth.  Returns (model, numpy var)."""
    from nf_tpu.config import NetworkConfig
    from nf_tpu.core import Ctx
    from nf_tpu.models import build_model

    cfg = NetworkConfig(name=name, layers=layers, base_filters=filters,
                        mixtures=mixtures, logdet=logdet, spnorm_coeff=spnorm_coeff)
    model = build_model(name, (D,), datatype="2d", cfg=cfg)
    rng = jax.random.PRNGKey(seed)
    var = model.init(rng)
    x = normal(seed + 100, (batch, D))
    var = model.data_dependent_init(var, x * 1.5 + 0.3)
    if name in ("realnvp", "glow"):
        ctx_t = Ctx(rng=jax.random.fold_in(rng, 2), train=True)
        fwd = jax.jit(lambda v, y: model.bijector.forward(v, y, ctx_t)[2])
        for _ in range(3):
            var = {"params": var["params"], "state": fwd(var, x * 1.3)}
    return model, to_numpy(var)


def torch_model(name: str, D: int, layers: int, filters: int, var=None,
                mixtures: int = 4, logdet: str = "unbias", spnorm_coeff: float = 0.9):
    """The port's density model on the CPU, with ``var`` (an nf_tpu
    variables pytree of numpy arrays) loaded when given."""
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.convert import load_jax_variables
    from nf_tpu_torch.models import build_model

    cfg = NetworkConfig(name=name, layers=layers, base_filters=filters,
                        mixtures=mixtures, logdet=logdet, spnorm_coeff=spnorm_coeff)
    model = build_model(name, (D,), "2d", cfg, device="cpu")
    if var is not None:
        load_jax_variables(model, var)
    return model


def uniform(seed: int, shape, low: float = 0.05, high: float = 0.95) -> np.ndarray:
    """Pixels away from the Logit edges, as bench.py makes its batches."""
    return np.random.default_rng(seed).uniform(low, high, shape).astype(np.float32)


def jax_image_model(dims=(16, 16, 1), layers: int = 1, filters: int = 8, seed: int = 0,
                    batch: int = 16, train_passes: int = 3):
    """nf_tpu's image RealNVP after its data-dependent init and
    ``train_passes`` train-mode passes, which move every batch-norm
    running statistic off its init value.  Returns (model, numpy var)."""
    from nf_tpu.config import NetworkConfig
    from nf_tpu.core import Ctx
    from nf_tpu.models import build_model

    cfg = NetworkConfig(name="realnvp", layers=layers, base_filters=filters)
    model = build_model("realnvp", dims, datatype="image", cfg=cfg)
    var = model.init(jax.random.PRNGKey(seed))
    x = uniform(seed + 100, (batch,) + tuple(dims))
    var = model.data_dependent_init(var, x)
    ctx_t = Ctx(rng=None, train=True)
    fwd = jax.jit(lambda v, y: model.bijector.forward(v, y, ctx_t)[2])
    for i in range(train_passes):
        var = {"params": var["params"], "state": fwd(var, uniform(seed + 101 + i, x.shape))}
    return model, to_numpy(var)


def torch_image_model(dims=(16, 16, 1), layers: int = 1, filters: int = 8, var=None):
    """The port's image RealNVP on the CPU, with ``var`` loaded when given."""
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.convert import load_jax_variables
    from nf_tpu_torch.models import build_model

    cfg = NetworkConfig(name="realnvp", layers=layers, base_filters=filters)
    model = build_model("realnvp", dims, "image", cfg, device="cpu")
    if var is not None:
        load_jax_variables(model, var)
    return model


def jax_realnvp(D: int, layers: int, filters: int, seed: int = 0, batch: int = 64):
    return jax_model("realnvp", D, layers, filters, seed, batch)


def torch_realnvp(D: int, layers: int, filters: int, var=None):
    return torch_model("realnvp", D, layers, filters, var)


def nf_unbias_probes(B: int, D: int):
    """nf_tpu's serving 'unbias' draws (PRNGKey(0), the key every eval block
    uses) in the port's layout: (V (S, B, D), n_terms (S,) int32)."""
    from nf_tpu.ops.pallas.fused_resflow import draw_unbias_probes

    V, thr, _ = draw_unbias_probes(B, D)
    return (torch.from_numpy(np.asarray(V).transpose(1, 2, 0).copy()),
            torch.from_numpy(np.asarray(thr)[0, :, 0].astype(np.int32)))


def nf_fixed_probes(B: int, D: int):
    """nf_tpu's serving 'fixed' draws from PRNGKey(0), port layout."""
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    return torch.from_numpy(np.stack([np.asarray(jax.random.normal(k, (B, D)))
                                      for k in keys])), None


def as_numpy(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(as_numpy(a), as_numpy(b), atol=atol, rtol=rtol)


# ------------------------------------------------------------ ResFlow training
def nf_train_draws(key, shape):
    """nf_tpu's training draws of one residual block from its key
    (``iresblock_forward``): ``k_val, k_grad = split(key)``, the value pair
    from ``split(k_val, 1)[0]``, the Neumann pair from ``k_grad``, each
    ``(kn, kv) -> (1 + geometric(kn), normal(kv, shape))``; in the port's
    ``((n_val, v_val), (n_grad, v_grad))``."""
    from nf_tpu.ops.estimators import geometric

    k_val, k_grad = jax.random.split(key)
    out = []
    for k in (jax.random.split(k_val, 1)[0], k_grad):
        kn, kv = jax.random.split(k)
        out.append((1 + int(geometric(kn, 0.5)),
                    torch.from_numpy(np.array(jax.random.normal(kv, tuple(shape))))))
    return tuple(out)


def nf_eval_draws(shape):
    """nf_tpu's serving 'unbias' draws (PRNGKey(0)) of the data's shape:
    (V (4, *shape), n_terms (4,) int32)."""
    from nf_tpu.ops.estimators import geometric

    vs, ns = [], []
    for k in jax.random.split(jax.random.PRNGKey(0), 4):
        kn, kv = jax.random.split(k)
        ns.append(8 + int(geometric(kn, 0.5)))
        vs.append(np.asarray(jax.random.normal(kv, tuple(shape))))
    return torch.from_numpy(np.stack(vs)), torch.tensor(ns, dtype=torch.int32)


def resflow_block_pair(conv: bool, coeff: float, seed: int = 3):
    """nf_tpu's residual block (dense g on (7, 3), or conv g on 4x4x2 with
    the operator spectral norm) and the port's with its variables, the
    LipSwish betas off 1.  Returns (nf_tpu block, numpy var, port block,
    input shape)."""
    from nf_tpu.bijectors.iresblock import InvertibleResConv2d as JRC
    from nf_tpu.bijectors.iresblock import InvertibleResLinear as JRL
    from nf_tpu_torch.bijectors.iresblock import InvertibleResConv2d, InvertibleResLinear
    from nf_tpu_torch.convert import load_jax_variables

    if conv:
        shape = (5, 4, 4, 2)
        kw = dict(base_filters=8, coeff=coeff, spatial=(4, 4))
        jb, tb = JRC(2, 2, **kw), InvertibleResConv2d(2, 2, device="cpu", **kw)
    else:
        shape = (7, 3)
        jb = JRL(3, 3, base_filters=8, coeff=coeff)
        tb = InvertibleResLinear(3, 3, base_filters=8, coeff=coeff, device="cpu")
    var = to_numpy(jb.init(jax.random.PRNGKey(seed)))
    var["params"]["g"][1]["beta"] = np.float32([0.8])
    var["params"]["g"][3]["beta"] = np.float32([1.3])
    load_jax_variables(tb, var)
    return jb, var, tb, shape


def jax_resflow(dims, datatype, layers, filters, seed=0):
    """nf_tpu's ResFlow (``allow_image`` for image data) and its init var."""
    from nf_tpu.config import NetworkConfig
    from nf_tpu.models import build_model

    cfg = NetworkConfig(name="resflow", layers=layers, base_filters=filters,
                        allow_image=datatype == "image")
    model = build_model("resflow", dims, datatype=datatype, cfg=cfg)
    return model, model.init(jax.random.PRNGKey(seed))


def torch_resflow(dims, datatype, layers, filters, var=None):
    """The port's ResFlow on the CPU, with ``var`` loaded when given."""
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.convert import load_jax_variables
    from nf_tpu_torch.models import build_model

    cfg = NetworkConfig(name="resflow", layers=layers, base_filters=filters,
                        allow_image=datatype == "image")
    model = build_model("resflow", dims, datatype, cfg, device="cpu")
    if var is not None:
        load_jax_variables(model, to_numpy(var))
    return model


def resflow_trainer_parity(dims, datatype, layers, filters, batches, logp_atol):
    """Three Trainer steps of the port's ResFlow against nf_tpu's, every
    block handed nf_tpu's draws (the data-dependent init's key
    ``fold_in(PRNGKey(0), 1)``, each step's ``fold_in(PRNGKey(0), step)``,
    folded with the block's chain index): the first step's gradients
    within 1e-5 + 1e-5 relative, the losses within rtol 1e-5, every
    parameter and u / v within 1e-5 after the steps, and u, v and the
    LipSwish betas moved by them; then the trained state served by both
    EvalPrograms on ``batches[0]`` with nf_tpu's serving draws: log p
    within ``logp_atol``, the inverse within 1e-4.  Returns the port's
    program."""
    from nf_tpu.config import OptimizerConfig as JOptimizerConfig
    from nf_tpu.core import Ctx
    from nf_tpu.train import Trainer as JTrainer
    from nf_tpu_torch.bijectors.iresblock import InvertibleResBlock
    from nf_tpu_torch.config import OptimizerConfig
    from nf_tpu_torch.convert import load_jax_variables
    from nf_tpu_torch.train import Trainer

    jm, var0 = jax_resflow(dims, datatype, layers, filters)
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

    tm = torch_resflow(dims, datatype, layers, filters)
    blocks = [(i, m) for i, m in enumerate(tm.bijector.layers)
              if isinstance(m, InvertibleResBlock)]
    inner = (batches.shape[1],) + ((dims[0] // 2, dims[1] // 2, 4 * dims[2])
                                   if datatype == "image" else tuple(dims))
    tt = Trainer(tm, OptimizerConfig(), seed=0)
    dd_key = jax.random.fold_in(key, 1)
    for i, m in blocks:
        m.injected_train_probes = nf_train_draws(jax.random.fold_in(dd_key, i), inner)
    ts = tt.init_state(torch.from_numpy(batches[0]),
                       params=load_jax_variables(tm, to_numpy(var0)))
    start = {k: v.clone() for k, v in tm.state_dict().items()}
    losses = []
    for k in range(1, 4):
        step_key = jax.random.fold_in(key, ts.step)
        for i, m in blocks:
            m.injected_train_probes = nf_train_draws(jax.random.fold_in(step_key, i), inner)
        ts, lt = tt.train_step(ts, torch.from_numpy(batches[k]))
        losses.append(float(lt))
        if k == 1:
            want = torch_resflow(dims, datatype, layers, filters,
                                 {"params": jgrads, "state": jts.state})
            want = dict(want.named_parameters())
            for name, p in tm.named_parameters():
                close(p.grad, want[name].detach(), 1e-5, 1e-5)
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    ref = torch_resflow(dims, datatype, layers, filters, jts.var).state_dict()
    for name, got in tm.state_dict().items():
        close(got.float(), ref[name].float(), 1e-5)
        if name.endswith((".u", ".v", ".beta")):
            assert not torch.equal(got, start[name]), name

    prog = tm.eval_program(probes=nf_eval_draws(inner))
    jprog = jm.eval_program(jts.var)
    x = batches[0]
    close(prog.log_prob(torch.from_numpy(x)), jprog.log_prob(x), logp_atol)
    jz, _ = jprog.forward(x)
    close(prog.inverse(torch.from_numpy(np.array(jz)))[0], jprog.inverse(jz)[0], 1e-4)
    return prog
