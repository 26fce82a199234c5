"""The port's MAF against nf_tpu's, on the CPU.

* ``made_degrees`` / ``degrees_to_masks`` (the port's own copies) against
  nf_tpu's on the same numpy generator, exactly; the masks a MADE draws at
  init are autoregressive;
* ``MADE`` (with and without the companion term) and
  ``AutoregressiveTransform`` with nf_tpu's variables carried across, in
  eval and train mode (outputs and the running statistics they move), and
  the transform's D-pass inverse: atol 2e-5 per module;
* the density model's log p and inverse against nf_tpu's EvalProgram, and
  the ``allow_image`` variant at 4x4x1 (``Logit`` -> ``Flatten`` -> stack
  -> ``Inverted(Flatten)``): atol 1e-4 per program, image log-densities
  3e-4; image data without ``allow_image`` raises nf_tpu's message;
* ``resample_masks``: the two frameworks' draws cannot match, so the same
  masks are injected into both (nf_tpu's ``_sample_masks_traced``, the
  port's ``sample_masks``) and a train-mode forward with a key / a
  generator is held at 2e-5; the port's own draws are autoregressive,
  repeatable per generator seed, and taken only when a generator is
  handed in (the Trainer's, one per step).
"""
import jax
import numpy as np
import pytest
import torch
from _torch_parity import close, flag_parity, normal, to_numpy, uniform

from nf_tpu.bijectors import made as jmade
from nf_tpu.core import Ctx
from nf_tpu_torch.bijectors import made as tmade
from nf_tpu_torch.convert import load_jax_variables

EVAL = Ctx(rng=None, train=False)
TRAIN = Ctx(rng=None, train=True)


def _t(a):
    return torch.from_numpy(np.array(a))


def _moved(var, seed, scale=0.05):
    """Every parameter moved off its init by seeded noise."""
    leaves, tree = jax.tree.flatten(to_numpy(var)["params"])
    leaves = [np.asarray(l) + normal(seed + i, np.shape(l), scale)
              for i, l in enumerate(leaves)]
    return {"params": jax.tree.unflatten(tree, leaves), "state": to_numpy(var)["state"]}


def _train_passes(fwd, var, xs):
    """nf_tpu train-mode passes that move the running statistics."""
    for x in xs:
        var = {"params": var["params"], "state": fwd(var, x)}
    return to_numpy(var)


def _autoregressive(masks, d):
    """Output i of the masked stack depends on inputs < i only."""
    conn = np.eye(d)
    for m in masks:                       # (out, in) each
        conn = (np.asarray(m) @ conn > 0).astype(np.float64)
    return bool(np.all(conn * (np.arange(d)[None, :] >= np.arange(d)[:, None]) == 0))


@pytest.mark.parametrize("d", [2, 5, 7])
def test_made_masks_match_nf_tpu(d):
    hidden = [8, 8, 8]
    tdeg = tmade.made_degrees(d, hidden, np.random.default_rng(d))
    jdeg = jmade.made_degrees(d, hidden, np.random.default_rng(d))
    for a, b in zip(tdeg, jdeg):
        np.testing.assert_array_equal(a, b)
    tmasks = tmade.degrees_to_masks(tdeg, d)
    for a, b in zip(tmasks, jmade.degrees_to_masks(jdeg, d)):
        np.testing.assert_array_equal(a, b)
    made = tmade.MADE(d, 3, 8, device="cpu")
    made.init(torch.Generator().manual_seed(d))
    masks = made.masks()
    assert [tuple(m.shape) for m in masks] == [(8, d), (8, 8), (8, 8), (d, 8)]
    assert set(torch.cat([m.flatten() for m in masks]).tolist()) <= {0.0, 1.0}
    assert _autoregressive(masks, d) and _autoregressive([m.T for m in tmasks], d)


@pytest.mark.parametrize("companion", [False, True])
def test_made_matches_nf_tpu(companion):
    d, bf = 5, 8
    jm = jmade.MADE(d, 2, bf, use_companion=companion)
    fwd = jax.jit(lambda v, x: jm.apply(v, x, TRAIN)[1])
    var = _train_passes(fwd, jm.init(jax.random.PRNGKey(1)),
                        [normal(10 + k, (32, d)) for k in range(2)])
    var = _moved(var, 20)
    tm = tmade.MADE(d, 2, bf, use_companion=companion, device="cpu")
    load_jax_variables(tm, var)
    for m, jmask in zip(tm.masks(), var["state"]["masks"]):
        np.testing.assert_array_equal(m.numpy(), np.asarray(jmask).T)
    x = normal(30, (16, d))
    tm.eval()
    with torch.no_grad():
        close(tm(_t(x)), jm.apply(var, x, EVAL)[0], 2e-5)
    tm.train()
    jh, jstate = jm.apply(var, x, TRAIN)
    close(tm(_t(x)).detach(), jh, 2e-5)
    want = tmade.MADE(d, 2, bf, use_companion=companion, device="cpu")
    load_jax_variables(want, {"params": var["params"], "state": to_numpy(jstate)})
    for name, buf in tm.named_buffers():
        close(buf, want.get_buffer(name), 2e-5)


@pytest.fixture(scope="module")
def transform():
    d, bf = 5, 8
    jt = jmade.AutoregressiveTransform(d, base_filters=bf)
    fwd = jax.jit(lambda v, x: jt.forward(v, x, TRAIN)[2])
    var = _train_passes(fwd, jt.init(jax.random.PRNGKey(2)),
                        [normal(40 + k, (32, d)) for k in range(2)])
    return jt, _moved(var, 50)


def _port_transform(var, **kw):
    tt = tmade.AutoregressiveTransform(5, base_filters=8, device="cpu", **kw)
    load_jax_variables(tt, var)
    return tt


def test_autoregressive_transform_matches_nf_tpu(transform):
    jt, var = transform
    tt = _port_transform(var)
    assert tt.perm.tolist() == np.asarray(var["state"]["perm"]).tolist()
    x = normal(60, (16, 5))
    tt.eval()
    with torch.no_grad():
        y, ld = tt(_t(x))
    jy, jld, _ = jt.forward(var, x, EVAL)
    close(y, jy, 2e-5)
    close(ld, jld, 2e-5)
    tt.train()
    y, ld = tt(_t(x))
    jy, jld, _ = jt.forward(var, x, TRAIN)
    close(y.detach(), jy, 2e-5)
    close(ld.detach(), jld, 2e-5)


def test_autoregressive_inverse_is_d_passes(transform, monkeypatch):
    """The inverse solves one column per pass, D passes of both MADEs, on
    their running statistics even in train mode, as nf_tpu's."""
    jt, var = transform
    tt = _port_transform(var)
    y = normal(61, (16, 5))
    calls = []
    forward = tmade.MADE.forward
    monkeypatch.setattr(tmade.MADE, "forward",
                        lambda self, z, generator=None: calls.append(self.training)
                        or forward(self, z, generator))
    for mode in (False, True):
        tt.train(mode)
        calls.clear()
        with torch.no_grad():
            x, ldi = tt.inverse(_t(y))
        assert calls == [False] * 10 and tt.training == mode
        jx, jldi, _ = jt.inverse(var, y, TRAIN if mode else EVAL)
        close(x, jx, 2e-5)
        close(ldi, jldi, 2e-5)
    tt.eval()
    with torch.no_grad():
        yr, ld = tt(x)
    close(yr, y, 2e-5)
    close(ld, -ldi, 2e-5)


def _jax_maf(dims, datatype, seed=0, **kw):
    from nf_tpu.config import NetworkConfig
    from nf_tpu.models import build_model

    cfg = NetworkConfig(name="maf", layers=2, base_filters=8, **kw)
    model = build_model("maf", dims, datatype=datatype, cfg=cfg)
    var = model.init(jax.random.PRNGKey(seed))
    make = (lambda s: uniform(s, (32,) + dims)) if datatype == "image" else \
        (lambda s: normal(s, (32,) + dims) * 1.3 + 0.2)
    var = model.data_dependent_init(var, make(seed + 100))
    fwd = jax.jit(lambda v, y: model.bijector.forward(v, y, TRAIN)[2])
    var = _train_passes(fwd, var, [make(seed + 101 + k) for k in range(2)])
    return model, _moved(var, seed + 200)


def _torch_maf(dims, datatype, var=None, **kw):
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.models import build_model

    model = build_model("maf", dims, datatype,
                        NetworkConfig(name="maf", layers=2, base_filters=8, **kw), device="cpu")
    if var is not None:
        load_jax_variables(model, var)
    return model


@pytest.mark.parametrize("D", [2, 3])
def test_maf_density_matches_nf_tpu(D):
    jm, var = _jax_maf((D,), "2d", seed=D)
    tm = _torch_maf((D,), "2d", var)
    prog, jprog = tm.eval_program(), jm.eval_program(var)
    assert prog.stack is None                 # the eager chain, as nf_tpu's
    x = normal(70 + D, (64, D)) * 1.3 + 0.2
    z, ld = prog.forward(_t(x))
    jz, jld = jprog.forward(x)
    close(z, jz, 1e-4)
    close(ld, jld, 1e-4)
    close(prog.log_prob(_t(x)), jprog.log_prob(x), 1e-4)
    zin = normal(80 + D, (64, D))
    y, ldi = prog.inverse(_t(zin))
    jy, jldi = jprog.inverse(zin)
    close(y, jy, 1e-4)
    close(ldi, jldi, 1e-4)


def test_maf_image_variant_matches_nf_tpu():
    dims = (4, 4, 1)
    jm, var = _jax_maf(dims, "image", allow_image=True)
    tm = _torch_maf(dims, "image", var, allow_image=True)
    names = [type(l).__name__ for l in tm.bijector.layers]
    assert names[:2] == ["Logit", "Flatten"] and names[-1] == "Inverted"
    assert names[2:-1] == ["BatchNorm", "AutoregressiveTransform"] * 2
    prog, jprog = tm.eval_program(), jm.eval_program(var)
    x = uniform(90, (16,) + dims)
    z, ld = prog.forward(_t(x))
    jz, jld = jprog.forward(x)
    assert z.shape == (16,) + dims
    close(z, jz, 1e-4)
    close(ld, jld, 3e-4)
    close(prog.log_prob(_t(x)), jprog.log_prob(x), 3e-4)
    y, ldi = prog.inverse(z)
    jy, jldi = jprog.inverse(jz)
    close(y, jy, 1e-4)
    close(y, x, 1e-4)
    close(ldi, jldi, 3e-4)


def test_maf_image_needs_allow_image():
    from nf_tpu.config import NetworkConfig
    from nf_tpu.models import build_model

    with pytest.raises(NotImplementedError) as jerr:
        build_model("maf", (4, 4, 1), datatype="image", cfg=NetworkConfig(name="maf"))
    with pytest.raises(NotImplementedError) as terr:
        _torch_maf((4, 4, 1), "image")
    assert str(terr.value) == str(jerr.value)
    for kw in (dict(scan=True), dict(remat=True)):       # built as nf_tpu builds them
        flag_parity("maf", (2,), "2d", 1e-4, layers=2, base_filters=8, **kw)


def test_resample_masks_with_injected_masks(monkeypatch):
    """A train-mode forward that draws its masks: the same masks injected
    into both packages give the same output; without a key / generator
    both keep the masks drawn at init."""
    d, bf = 5, 8
    jt = jmade.AutoregressiveTransform(d, base_filters=bf, resample_masks=True)
    var = _moved(jt.init(jax.random.PRNGKey(3)), 100)
    tt = tmade.AutoregressiveTransform(d, base_filters=bf, resample_masks=True, device="cpu")
    load_jax_variables(tt, var)
    made = tmade.MADE(d, 3, bf, device="cpu")
    drawn = []
    for k in range(2):                        # net_s's masks, then net_t's
        made.init(torch.Generator().manual_seed(7 + k))
        drawn.append([m.clone() for m in made.masks()])
    queue = []
    monkeypatch.setattr(jmade.MADE, "_sample_masks_traced",
                        lambda self, key: [jax.numpy.asarray(m.numpy().T) for m in queue.pop(0)])
    monkeypatch.setattr(tmade.MADE, "sample_masks", lambda self, g: queue.pop(0))
    x = normal(101, (32, d))
    queue[:] = drawn
    jy, jld, _ = jt.forward(var, x, Ctx(rng=jax.random.PRNGKey(9), train=True))
    assert not queue
    tt.train()
    queue[:] = drawn
    y, ld = tt(_t(x), torch.Generator().manual_seed(9))
    assert not queue
    close(y.detach(), jy, 2e-5)
    close(ld.detach(), jld, 2e-5)
    y0, _ = tt(_t(x))                           # no generator: the init masks
    jy0, _, _ = jt.forward(var, x, TRAIN)
    close(y0.detach(), jy0, 2e-5)
    assert float((y0 - y).detach().abs().max()) > 1e-3


def test_sample_masks_are_autoregressive_and_seeded():
    d = 6
    made = tmade.MADE(d, 3, 16, resample_masks=True, device="cpu")
    draws = [made.sample_masks(torch.Generator().manual_seed(s)) for s in (0, 0, 1)]
    for masks in draws:
        assert [tuple(m.shape) for m in masks] == [(16, d), (16, 16), (16, 16), (d, 16)]
        assert _autoregressive(masks, d)
    assert all(torch.equal(a, b) for a, b in zip(draws[0], draws[1]))
    assert not all(torch.equal(a, b) for a, b in zip(draws[0], draws[2]))
    # the first hidden degrees spread over [0, d - 2], as made_degrees'
    first = {int(m.sum()) for s in range(20)
             for m in made.sample_masks(torch.Generator().manual_seed(s))[0]}
    assert first == set(range(1, d))


def test_trainer_hands_each_step_its_generator(monkeypatch):
    """Trainer.train_step hands the MAF layers a generator seeded from
    (seed, step): a step's draws repeat, and the next step's differ.  The
    data-dependent init draws too, from its own generator (nf_tpu's
    data_dependent_init hands its layers a key)."""
    from nf_tpu_torch.config import OptimizerConfig
    from nf_tpu_torch.train import Trainer

    model = _torch_maf((5,), "2d", resample_masks=True)
    tr = Trainer(model, OptimizerConfig(), seed=4)
    seen = []
    sample = tmade.MADE.sample_masks
    monkeypatch.setattr(tmade.MADE, "sample_masks",
                        lambda self, g: seen.append(g.initial_seed()) or sample(self, g))
    batch = torch.from_numpy(normal(110, (16, 5)))
    ts = tr.init_state(batch)
    assert len(seen) == 2 * 2 and set(seen) == {tr.dd_generator().initial_seed()}
    seen.clear()
    ts, _ = tr.train_steps(ts, torch.stack([batch, batch]))
    assert len(seen) == 2 * 2 * 2                # 2 steps x 2 layers x 2 MADEs
    assert len(set(seen[:4])) == 1 and len(set(seen[4:])) == 1 and seen[0] != seen[4]
    assert seen[0] == tr.step_generator(0).initial_seed()
    assert seen[4] == tr.step_generator(1).initial_seed()
