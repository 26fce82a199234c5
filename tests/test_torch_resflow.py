"""The port's ResFlow density serving path against nf_tpu's, on the CPU.

nf_tpu's eval blocks draw their probes from PRNGKey(0); JAX's stream cannot
be reproduced, so every comparison hands the port nf_tpu's own draws
(``_torch_parity.nf_unbias_probes`` / ``nf_fixed_probes``).

* ``SpectralNormDense`` (capped and uncapped sigma), ``LipSwish`` and
  ``logdet_exact``: atol 2e-5; ``geometric`` exactly, on nf_tpu's own
  uniforms; ``logdet_fixed`` / ``logdet_unbias``: atol 1e-4 (up to 40
  products J^T w summed in another order);
* ``InvertibleResBlock``: forward atol 2e-5 on y and 1e-4 on the log-det;
  the inverse's fixed point in the same number of trips as nf_tpu's, x
  within 2e-5 and the log-det within 1e-4;
* the whole slice at full depth (32 blocks, F = 32, D = 2, B = 256): the
  port's EvalProgram against nf_tpu's ``eval_program`` (its chain on the
  CPU), 'unbias' and 'exact': z and x atol 1e-4, log-dets 5e-4 (32 blocks
  of series sums in another order).
"""
import jax
import numpy as np
import pytest
import torch
from _torch_parity import (close, jax_model, nf_fixed_probes, nf_unbias_probes, normal,
                           to_numpy, torch_model)

from nf_tpu.core import Ctx
from nf_tpu.ops import estimators as jest
from nf_tpu_torch.ops import estimators as test_

ATOL = 2e-5
SERIES_ATOL = 1e-4
EVAL = Ctx(rng=None, train=False)


def _t(a):
    return torch.tensor(np.asarray(a))


def _load(module, var):
    from nf_tpu_torch.convert import load_jax_variables
    load_jax_variables(module, to_numpy(var))
    return module.eval()


# --------------------------------------------------------------- modules
@pytest.mark.parametrize("coeff,capped", [(0.5, True), (50.0, False)])
def test_spectral_norm_dense(coeff, capped):
    from nf_tpu.nets.spectral import SpectralNormDense as JSN
    from nf_tpu_torch.nets.spectral import SpectralNormDense

    js = JSN(3, 7, coeff=coeff)
    var = to_numpy(js.init(jax.random.PRNGKey(1)))
    ts = _load(SpectralNormDense(3, 7, coeff=coeff, device="cpu"), var)
    w = ts.weight()
    assert capped == (not torch.equal(w, ts.w_bar)), "sigma on the wrong side of coeff"
    x = normal(1, (19, 3), 1.5)
    close(ts(_t(x)).detach(), js.apply(var, x, EVAL)[0], ATOL)


def test_spectral_norm_init_warm_starts_sigma():
    from nf_tpu_torch.nets.spectral import SpectralNormDense

    sn = SpectralNormDense(5, 9, device="cpu")
    sn.init(torch.Generator().manual_seed(0))
    w = sn.w_bar.detach()
    norm = float(torch.linalg.matrix_norm(w, ord=2))
    sigma = float(sn.u @ (w.T @ sn.v))
    assert abs(sigma - norm) < 1e-3
    # a train-mode forward runs one more power iteration on the warm pair
    u = sn.u.clone()
    sn.train()(torch.zeros(2, 5))
    assert not torch.equal(sn.u, u)
    assert abs(float(sn.u @ (w.T @ sn.v)) - norm) < 1e-3


def test_lipswish():
    from nf_tpu.nets.spectral import LipSwish as JLS
    from nf_tpu_torch.nets.spectral import LipSwish

    var = {"params": {"beta": np.float32([0.7])}, "state": {}}
    x = normal(2, (13, 6), 3.0)
    close(_load(LipSwish(device="cpu"), var)(_t(x)).detach(),
          JLS().apply(var, x, EVAL)[0], ATOL)


def test_geometric_on_nf_tpus_uniforms():
    tiny = np.finfo(np.float32).tiny
    for i in range(64):
        key = jax.random.PRNGKey(i)
        u = jax.random.uniform(key, (), minval=tiny)     # what jest.geometric draws
        assert int(test_.geometric(_t(u), 0.5)) == int(jest.geometric(key, 0.5)), i
    assert int(test_.geometric(torch.tensor(tiny), 0.5)) == test_.SERIES_CAP
    assert int(test_.geometric(torch.tensor(1.0 - 2 ** -24), 0.5)) == 1


def _g_pair(D=3, F=16, seed=3):
    """An nf_tpu g-net (the residual block's) and the port's with its
    variables, LipSwish betas off 1."""
    from nf_tpu.bijectors.iresblock import InvertibleResLinear as JRL
    from nf_tpu_torch.bijectors.iresblock import InvertibleResLinear

    jb = JRL(D, D, base_filters=F, coeff=0.9)
    var = to_numpy(jb.init(jax.random.PRNGKey(seed)))
    var["params"]["g"][1]["beta"] = np.float32([0.8])
    var["params"]["g"][3]["beta"] = np.float32([1.3])
    tb = _load(InvertibleResLinear(D, D, base_filters=F, coeff=0.9, device="cpu"), var)
    g_fn = jb._g_apply_pure(var["state"]["g"])
    return jb, var, tb, (lambda xx: g_fn(var["params"]["g"], xx))


def test_logdet_exact():
    _, _, tb, jg = _g_pair()
    x = normal(4, (17, 3), 1.5)
    close(test_.logdet_exact(tb.g_net, _t(x)).detach(), jest.logdet_exact(jg, x), ATOL)


def test_logdet_fixed_with_injected_probes():
    _, _, tb, jg = _g_pair()
    x = normal(5, (21, 3), 1.5)
    want = jest.logdet_fixed(jg, x, jax.random.PRNGKey(0), n_samples=4, n_power_series=8)
    v, _ = nf_fixed_probes(21, 3)
    close(test_.logdet_fixed(tb.g_net, _t(x), v, 8).detach(), want, SERIES_ATOL)


def test_logdet_unbias_with_injected_probes():
    _, _, tb, jg = _g_pair()
    x = normal(6, (21, 3), 1.5)
    want = jest.logdet_unbias(jg, x, jax.random.PRNGKey(0), n_samples=4, n_exact=8)
    v, n_terms = nf_unbias_probes(21, 3)
    got = test_.logdet_unbias(tb.g_net, _t(x), v, n_terms, p=0.5, n_exact=8)
    close(got.detach(), want, SERIES_ATOL)


def test_draws_have_nf_tpus_structure():
    g = torch.Generator().manual_seed(0)
    V, n_terms = test_.draw_unbias_probes(10, 3, g)
    assert V.shape == (4, 10, 3) and n_terms.dtype == torch.int32
    assert all(9 <= int(n) <= 40 for n in n_terms)
    V2, n2 = test_.eval_probes("unbias", 10, 3, "cpu")
    assert torch.equal(V, V2) and torch.equal(n_terms, n2)
    assert test_.eval_probes("exact", 10, 3, "cpu") is None
    assert test_.eval_probes("fixed", 10, 3, "cpu")[0].shape == (4, 10, 3)
    with pytest.raises(ValueError):
        test_.eval_probes("neumann", 10, 3, "cpu")


def _trip_counter(monkeypatch):
    """Records the final trip count of nf_tpu's fixed-point while loops."""
    trips = []
    original = jax.lax.while_loop

    def spy(cond, body, init):
        out = original(cond, body, init)
        if len(out) == 3:
            trips.append(int(out[2]))
        return out

    monkeypatch.setattr(jax.lax, "while_loop", spy)
    return trips


@pytest.mark.parametrize("estimator", ["unbias", "fixed", "exact"])
def test_invertible_res_block(monkeypatch, estimator):
    from nf_tpu.bijectors.iresblock import InvertibleResLinear as JRL
    from nf_tpu_torch.bijectors.iresblock import InvertibleResLinear

    jb = JRL(2, 2, base_filters=16, coeff=0.9, logdet_estimator=estimator)
    var = to_numpy(jb.init(jax.random.PRNGKey(7)))
    tb = _load(InvertibleResLinear(2, 2, base_filters=16, coeff=0.9,
                                   logdet_estimator=estimator, device="cpu"), var)
    x = normal(7, (40, 2), 1.5)
    probes = {"unbias": nf_unbias_probes, "fixed": nf_fixed_probes,
              "exact": lambda B, D: None}[estimator](40, 2)
    with torch.no_grad():
        y, ld = tb(_t(x), probes)
        jy, jld, _ = jb.forward(var, x, EVAL)
        close(y, jy, ATOL)
        close(ld, jld, SERIES_ATOL)

        trips = _trip_counter(monkeypatch)
        jx, jldi, _ = jb.inverse(var, jy, EVAL)
        xs, it = tb.solve(_t(jy))
        assert trips and it == trips[0], (it, trips)
        xi, ldi = tb.inverse(_t(jy), probes)
        close(xi, jx, ATOL)
        close(xs, jx, ATOL)
        close(ldi, jldi, SERIES_ATOL)


# ------------------------------------------------------ the slice, full depth
@pytest.fixture(scope="module")
def unbias_full_depth():
    jmodel, var = jax_model("resflow", 2, 32, 32, seed=3, batch=256)
    return jmodel, var, torch_model("resflow", 2, 32, 32, var)


def test_eval_program_matches_nf_tpu_full_depth(unbias_full_depth):
    from nf_tpu_torch.ops.cuda import fused_resflow as tfr

    jmodel, var, tmodel = unbias_full_depth
    jprog = jmodel.eval_program(var)
    prog = tmodel.eval_program(probes=nf_unbias_probes(256, 2))
    assert isinstance(prog.stack, tfr.PackedResFlow) and prog.stack.kernel is None
    x = normal(7, (256, 2))
    before = dict(tfr.LAUNCHES)

    jz, jld = jprog.forward(x)
    z, ld = prog.forward(_t(x))
    close(z, jz, 1e-4)
    close(ld, jld, 5e-4)
    close(prog.log_prob(_t(x)), jprog.log_prob(x), 5e-4)

    jy, jldi = jprog.inverse(np.asarray(jz))
    y, ldi = prog.inverse(_t(jz))
    close(y, jy, 1e-4)
    close(ldi, jldi, 5e-4)
    close(y, x, 1e-4)
    assert tfr.LAUNCHES == before
    with pytest.raises(ValueError, match="batch of 256"):
        prog.forward(_t(x[:10]))


def test_eval_program_serving_probes_and_sample(unbias_full_depth):
    from nf_tpu_torch.ops.math import standard_normal_logprob

    *_, tmodel = unbias_full_depth
    prog = tmodel.eval_program()
    x = torch.from_numpy(normal(9, (64, 2)))
    with torch.no_grad():
        # the eager chain's blocks draw the same serving set as the program
        z, ld = tmodel(x)
    zp, ldp = prog.forward(x)
    close(zp, z, 1e-4)
    close(ldp, ld, 5e-4)
    assert len(prog._probe_sets) == 1 and 64 in prog._probe_sets

    y, log_py = prog.sample(64, torch.Generator().manual_seed(11))
    zs = torch.randn(64, 2, generator=torch.Generator().manual_seed(11))
    y2, ldi = prog.inverse(zs)
    close(y, y2, 0.0)
    close(log_py, standard_normal_logprob(zs) - ldi, 0.0)
    assert torch.isfinite(y).all() and torch.isfinite(log_py).all()


def test_eval_program_keeps_a_bounded_set_of_probe_sets():
    from nf_tpu_torch.models import base

    tmodel = torch_model("resflow", 2, 2, 8)
    prog = tmodel.eval_program(tmodel.init(torch.Generator().manual_seed(0)))
    x = torch.from_numpy(normal(13, (base.PROBE_SETS_KEPT + 3, 2)))
    _, first = prog.forward(x[:1])
    for B in range(2, x.shape[0] + 1):
        prog.forward(x[:B])
        assert len(prog._probe_sets) == min(B, base.PROBE_SETS_KEPT)
    assert 1 not in prog._probe_sets
    # drawn again after its eviction: the same set, the same log-det
    close(prog.forward(x[:1])[1], first, 0.0)


def test_eval_program_exact_matches_nf_tpu_full_depth():
    from nf_tpu_torch.ops.cuda import fused_resflow as tfr

    jmodel, var = jax_model("resflow", 2, 32, 32, seed=4, batch=256, logdet="exact")
    tmodel = torch_model("resflow", 2, 32, 32, var, logdet="exact")
    jprog = jmodel.eval_program(var)
    prog = tmodel.eval_program()
    assert prog.stack.spec.estimator == "exact"
    x = normal(12, (256, 2))
    jz, jld = jprog.forward(x)
    z, ld = prog.forward(_t(x))
    close(z, jz, 1e-4)
    close(ld, jld, 5e-4)
    jy, jldi = jprog.inverse(np.asarray(jz))
    y, ldi = prog.inverse(_t(jz))
    close(y, jy, 1e-4)
    close(ldi, jldi, 5e-4)
    # the inverse is the solve alone, then a chain forward at the solved x
    close(y, tfr.fused_resflow(prog.stack, _t(jz), "solve"), 0.0)


def test_image_mode_not_in_this_slice():
    """Image data without ``allow_image`` raises nf_tpu's message (the
    branch itself: test_torch_resflow_image.py)."""
    from nf_tpu.config import NetworkConfig as JNetworkConfig
    from nf_tpu.models import build_model as jbuild_model
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.models import build_model

    with pytest.raises(NotImplementedError) as jerr:
        jbuild_model("resflow", (8, 8, 1), "image", JNetworkConfig(name="resflow"))
    with pytest.raises(NotImplementedError, match="allow_image") as terr:
        build_model("resflow", (8, 8, 1), "image", NetworkConfig(name="resflow"), device="cpu")
    assert str(terr.value) == str(jerr.value)
