"""The port's probability-space mixture-CDF functions against nf_tpu's, on
the CPU.

* ``mix_cdf``, ``mix_log_cdf_forward``, ``logistic_logpdf`` and
  ``mix_logistic_logpdf``: atol 2e-5, rtol 1e-6;
* ``mix_log_cdf_inverse`` (the plain Newton a CPU tensor takes) against
  nf_tpu's ``mix_log_cdf_inverse`` and its Pallas kernel
  ``mix_log_cdf_inverse_pallas`` in interpret mode at (4, 128, 8), inputs
  as tests/test_pallas.py makes them: x atol 1e-4, log-det atol 1e-3, and
  the round trip to x within 1e-3, the tolerances nf_tpu holds its kernel
  to (two Newton solves meet the root only within XTOL);
* the same at an image shape (B, H, W, C) with K last;
* csrc/mixlogcdf.cu's early exit (a thread leaves the loop once its
  element is done) walked in PyTorch: the same x, bit for bit, as the
  fixed 24 trips, and the trips ``_newton_solve`` counts;
* the wrapper: no launch for a CPU tensor, the kernel's entry refuses CPU
  tensors and K past its tilings, and the Function has no gradient.
"""
import importlib

import jax
import numpy as np
import pytest
import torch
from _torch_parity import close, normal

from nf_tpu.bijectors import mixlogcdf as jm
from nf_tpu.ops import math as jmath
from nf_tpu_torch.bijectors import mixlogcdf as tm
from nf_tpu_torch.ops import math as tmath
from nf_tpu_torch.ops.cuda import mixlogcdf as cm

# the package exports a function of this name: take the module itself
jpallas = importlib.import_module("nf_tpu.ops.pallas.mixlogcdf")
ATOL = 2e-5


def _t(a):
    return torch.from_numpy(np.array(a))


def _inputs(seed, shape, K):
    """As tests/test_pallas.py: x = 2 N(0, 1), logpi = log_softmax(N(0, 1)),
    mu = N(0, 1), s = 0.3 N(0, 1); y = mix_log_cdf_forward(x)."""
    x = normal(seed, shape, 2.0)
    logpi = np.asarray(jax.nn.log_softmax(normal(seed + 1, shape + (K,)), axis=-1))
    mu = normal(seed + 2, shape + (K,))
    s = normal(seed + 3, shape + (K,), 0.3)
    y, _ = jm.mix_log_cdf_forward(x, logpi, mu, s)
    return x, np.asarray(y), logpi, mu, s


@pytest.mark.parametrize("shape,K", [((4, 128), 8), ((3, 4, 4, 2), 5)])
def test_forward_functions_match_nf_tpu(shape, K):
    x, _, logpi, mu, s = _inputs(1, shape, K)
    close(tm.mix_cdf(_t(x), _t(logpi), _t(mu), _t(s)), jm.mix_cdf(x, logpi, mu, s), ATOL, 1e-6)
    y, ld = tm.mix_log_cdf_forward(_t(x), _t(logpi), _t(mu), _t(s))
    jy, jld = jm.mix_log_cdf_forward(x, logpi, mu, s)
    close(y, jy, ATOL, 1e-6)
    close(ld, jld, ATOL, 1e-6)
    close(tmath.logistic_logpdf(_t(x)[..., None], _t(mu), _t(s)),
          jmath.logistic_logpdf(x[..., None], mu, s), ATOL, 1e-6)
    close(tmath.mix_logistic_logpdf(_t(x), _t(logpi), _t(mu), _t(s)),
          jmath.mix_logistic_logpdf(x, logpi, mu, s), ATOL, 1e-6)


def test_inverse_matches_nf_tpu_and_pallas_interpret():
    x, y, logpi, mu, s = _inputs(2, (4, 128), 8)
    got_x, got_ld = tm.mix_log_cdf_inverse(_t(y), _t(logpi), _t(mu), _t(s))
    jx, jld = jm.mix_log_cdf_inverse(y, logpi, mu, s)
    px, pld = jpallas.mix_log_cdf_inverse_pallas(y, logpi, mu, s, interpret=True)
    for want_x, want_ld in ((jx, jld), (px, pld)):
        close(got_x, want_x, 1e-4, 1e-4)
        close(got_ld, want_ld, 1e-3, 1e-4)
    close(got_x, x, 1e-3)


def test_inverse_at_an_image_shape():
    x, y, logpi, mu, s = _inputs(3, (3, 4, 4, 2), 5)
    got_x, got_ld = tm.mix_log_cdf_inverse(_t(y), _t(logpi), _t(mu), _t(s))
    jx, jld = jm.mix_log_cdf_inverse(y, logpi, mu, s)
    assert got_x.shape == y.shape and got_ld.shape == (3,)
    close(got_x, jx, 1e-4, 1e-4)
    close(got_ld, jld, 1e-3, 1e-4)
    close(got_x, x, 1e-3)


def _early_exit_solve(y, logpi, mu, s):
    """csrc/mixlogcdf.cu's loop in PyTorch: each element leaves at the
    first trip whose done test passes, keeping its x."""
    pi, inv = torch.exp(logpi), torch.exp(-s)
    use_lo = y < 0.5
    ly = torch.log(torch.clamp(y, min=tm.TINY))
    l1y = torch.log(torch.clamp(1.0 - y, min=tm.TINY))
    x = torch.zeros_like(y)
    lo, hi = torch.full_like(y, -tm.SPAN), torch.full_like(y, tm.SPAN)
    dxold = torch.full_like(y, 2.0 * tm.SPAN)
    live = torch.ones_like(y, dtype=torch.bool)
    trips = torch.zeros_like(y, dtype=torch.int64)
    for _ in range(tm.N_ITERS):
        trips += live
        sg = torch.sigmoid((x[..., None] - mu) * inv)
        cdf = tm._component_sum(pi * sg)
        pdf = tm._component_sum(pi * inv * sg * (1.0 - sg))
        fraw = cdf - y
        lo = torch.where(live & (fraw < 0), x, lo)
        hi = torch.where(live & (fraw >= 0), x, hi)
        c = torch.clamp(cdf, tm.TINY, 1.0 - 1.0e-7)
        f = torch.where(use_lo, torch.log(c) - ly, l1y - torch.log1p(-c))
        df = torch.clamp(torch.where(use_lo, pdf / c, pdf / (1.0 - c)), min=tm.TINY)
        dx = f / df
        xn = x - dx
        use_bis = ((xn <= lo) | (xn >= hi) | (torch.abs(2.0 * f) > torch.abs(dxold * df))
                   | ~torch.isfinite(xn))
        live = live & ~((torch.abs(dx) <= tm.XTOL) | ((hi - lo) <= tm.XTOL))
        dx = torch.where(use_bis, (hi - lo) * 0.5, dx)
        xn = torch.where(use_bis, (lo + hi) * 0.5, xn)
        x = torch.where(live, xn, x)
        dxold = torch.where(live, dx, dxold)
    return x, trips


def test_kernel_early_exit_gives_the_fixed_trip_result():
    """The same x, bit for bit, and ``_newton_solve``'s ``evaluations``
    count the trips the early exit runs."""
    _, y, logpi, mu, s = _inputs(4, (8, 256), 8)
    args = [_t(a) for a in (y, logpi, mu, s)]
    x, trips = _early_exit_solve(*args)
    counts = []
    assert torch.equal(x, tm._newton_solve(*args, evaluations=counts))
    assert torch.equal(counts[0], trips) and 1 <= int(trips.min()) < int(trips.max()) <= 24


def test_cpu_tensors_take_the_plain_version():
    _, y, logpi, mu, s = (_t(a) for a in _inputs(5, (2, 128), 8))
    before = dict(cm.LAUNCHES)
    x, ld = tm.mix_log_cdf_inverse(y, logpi, mu, s)
    assert cm.LAUNCHES == before
    want = tm.mix_log_cdf_inverse_reference(y, logpi, mu, s)
    close(x, want[0], 0.0)
    close(ld, want[1], 0.0)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cm.launch(y, logpi, mu, s)
    assert [cm.padded_mixtures(k) for k in (1, 8, 9, 32)] == [8, 8, 32, 32]
    with pytest.raises(NotImplementedError, match="K <= 32"):
        cm.padded_mixtures(33)
    with pytest.raises(NotImplementedError, match="no gradient"):
        cm.MixLogCdfInverse.backward(None, x, ld)
