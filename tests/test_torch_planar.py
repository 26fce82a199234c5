"""The port's Planar flow against nf_tpu's, on the CPU.

* ``bisect_monotone`` against nf_tpu's on the same monotone function and
  brackets, atol 2e-5, with no early exit (64 trips always);
* ``PlanarTransform`` forward and inverse with nf_tpu's variables carried
  across, where w.u >= -1 (u used as it is) and where w.u < -1 (u_hat):
  atol 2e-5 per module;
* the model (4 layers, D = 2): log p and the inverse against nf_tpu's
  EvalProgram, atol 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import close, flag_parity, normal, to_numpy

from nf_tpu.core import Ctx

EVAL = Ctx(rng=None, train=False)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_bisect_matches_nf_tpu():
    from nf_tpu.ops.bisect import bisect_monotone as jbisect
    from nf_tpu_torch.ops.bisect import bisect_monotone

    target = normal(0, (257,), 3.0)
    lo, hi = np.full_like(target, -1e3), np.full_like(target, 1e3)
    got = bisect_monotone(lambda a: a + 0.7 * torch.tanh(a - 0.2), _t(target), _t(lo), _t(hi))
    want = jbisect(lambda a: a + 0.7 * jnp.tanh(a - 0.2), target, lo, hi)
    close(got, want, 2e-5)
    close(got + 0.7 * torch.tanh(got - 0.2), target, 2e-5)
    trips = []
    bisect_monotone(lambda a: trips.append(1) or a, _t(target), _t(lo), _t(hi))
    assert len(trips) == 64


def _planar_var(dim, seed, wu):
    """nf_tpu's init, then u set so that w.u = ``wu``."""
    from nf_tpu.bijectors.planar import PlanarTransform as JPlanar

    jp = JPlanar(dim)
    var = to_numpy(jp.init(jax.random.PRNGKey(seed)))
    p = dict(var["params"])
    p["w"] = normal(seed + 1, (dim,))
    p["u"] = normal(seed + 2, (dim,), 0.5)
    p["u"] = (p["u"] + (wu - p["w"] @ p["u"]) * p["w"] / (p["w"] @ p["w"])).astype(np.float32)
    p["b"] = normal(seed + 3, (1,))
    return jp, {"params": p, "state": var["state"]}


@pytest.mark.parametrize("wu", [0.8, -0.6, -2.5])
@pytest.mark.parametrize("dim", [2, 5])
def test_planar_transform_matches_nf_tpu(dim, wu):
    from nf_tpu_torch.bijectors.planar import PlanarTransform
    from nf_tpu_torch.convert import load_jax_variables

    jp, var = _planar_var(dim, dim, wu)
    tp = PlanarTransform(dim, device="cpu")
    load_jax_variables(tp, var)
    with torch.no_grad():
        u, wu_c = tp._constrained()
    if wu < -1.0:      # the constraint replaces u, and w.u_hat >= -1
        assert not torch.allclose(u, tp.u) and float(wu_c) >= -1.0
    else:
        assert torch.equal(u, tp.u)
    x = normal(10 + dim, (64, dim), 2.0)
    with torch.no_grad():
        y, ld = tp(_t(x))
        jy, jld, _ = jp.forward(var, x, EVAL)
        close(y, jy, 2e-5)
        close(ld, jld, 2e-5)
        xr, ldi = tp.inverse(y)
        jx, jldi, _ = jp.inverse(var, np.asarray(jy), EVAL)
    close(xr, jx, 2e-5)
    close(ldi, jldi, 2e-5)
    close(xr, x, 1e-4)
    close(ldi, -ld, 2e-5)


def test_planar_model_matches_nf_tpu():
    from nf_tpu.config import NetworkConfig as JNC
    from nf_tpu.models import build_model as jbuild
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.convert import load_jax_variables
    from nf_tpu_torch.models import build_model

    jm = jbuild("planar", (2,), datatype="2d", cfg=JNC(name="planar", layers=4))
    var = to_numpy(jm.init(jax.random.PRNGKey(0)))
    params = [{k: v + normal(20 + 3 * i + j, v.shape, 0.5)
               for j, (k, v) in enumerate(sorted(p.items()))}
              for i, p in enumerate(var["params"])]
    var = {"params": params, "state": var["state"]}
    tm = build_model("planar", (2,), "2d", NetworkConfig(name="planar", layers=4), device="cpu")
    load_jax_variables(tm, var)
    assert len(tm.bijector.layers) == 4          # no BatchNorm between them
    prog, jprog = tm.eval_program(), jm.eval_program(var)
    assert prog.stack is None
    x = normal(30, (128, 2), 1.5)
    z, ld = prog.forward(_t(x))
    jz, jld = jprog.forward(x)
    close(z, jz, 1e-4)
    close(ld, jld, 1e-4)
    close(prog.log_prob(_t(x)), jprog.log_prob(x), 1e-4)
    zin = normal(31, (128, 2))
    y, ldi = prog.inverse(_t(zin))
    jy, jldi = jprog.inverse(zin)
    close(y, jy, 1e-4)
    close(ldi, jldi, 1e-4)
    for kw in (dict(scan=True), dict(remat=True)):       # built as nf_tpu builds them
        flag_parity("planar", (2,), "2d", 1e-4, layers=4, **kw)
