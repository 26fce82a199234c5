"""Logistic-mixture CDF transform (the Flow++ inner bijector); counterpart
of ``nf_tpu/bijectors/mixlogcdf.py``.

Probability space: ``mix_cdf`` is the direct positively weighted sum
``sum(pi * sigmoid)``, the one formula both ``mix_log_cdf_forward`` and
the inverse's solver evaluate, so the two agree on the root.
``mix_log_cdf_inverse`` solves ``MixLogisticCDF(x) = y`` with the
fixed-trip bracket-safeguarded Newton (``_newton_solve``: log-CDF space
below the median, log-survival space above it) and returns the log-det
``-sum log pdf(x)``.  It dispatches as every kernel of the port: a CPU
tensor takes the plain Newton, a CUDA tensor launches the hand-written
kernel (``ops/cuda/mixlogcdf.py``), which is inference only.  ``nf_tpu``'s
``NF_TPU_PALLAS_BISECT`` opt-in has no counterpart.

Logit space (the Flow++ couplings): ``y = logit(MixLogisticCDF(x))``
computed as ``u - v`` with ``u = log CDF`` and ``v = log(1 - CDF)``,
log-det ``logpdf - u - v``: exact in both tails, no clamp.  Its inverse is
the same Newton in logit space.

The constants equal ``nf_tpu``'s, and the CUDA kernels
(``csrc/fused_flowpp.cu``, ``csrc/mixlogcdf.cu``) use the same.  Mixture
components sit on the LAST axis.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.cuda import mixlogcdf as cuda_mixlogcdf
from ..ops.math import mix_logistic_logpdf, sum_except_batch

SPAN = 1.0e3
N_ITERS = 24
XTOL = 1.0e-5   # x-space convergence freeze
TINY = 1.0e-38  # a subnormal in f32: the CUDA build must not flush to zero


# --------------------------------------------------------------------------
# probability space
# --------------------------------------------------------------------------
def mix_cdf(x, logpi, mu, s):
    """Mixture CDF as ``sum(pi * sigmoid((x - mu) * exp(-s)))``."""
    return (torch.exp(logpi) * torch.sigmoid((x[..., None] - mu) * torch.exp(-s))).sum(-1)


def mix_log_cdf_forward(x, logpi, mu, s):
    """Returns (y, per-sample logdet)."""
    ld = sum_except_batch(mix_logistic_logpdf(x, logpi, mu, s))
    return mix_cdf(x, logpi, mu, s), ld


def _component_sum(t):
    """Sum over the last (mixture) axis in component order, each term
    rounded before it is added, as the CUDA kernel adds them: near y = 0 or
    1 the root moves by the CDF's rounding over the pdf, so the two solves
    agree only where they evaluate the CDF alike."""
    out = t[..., 0]
    for k in range(1, t.shape[-1]):
        out = out + t[..., k]
    return out


def _newton_solve(y, logpi, mu, s, n_iters: int = N_ITERS, evaluations=None):
    """Safeguarded Newton for MixLogisticCDF(x) = y, elementwise: Newton
    steps in log-CDF space below the median and in log-survival space
    above it; a proposal outside the open bracket, or failing the rtsafe
    step-halving test, takes the midpoint; a converged element freezes.
    ``evaluations``, a list, receives each element's count of mixture
    evaluations up to and including its first converged trip: what the
    CUDA kernel, which leaves the loop there, runs."""
    pi = torch.exp(logpi)
    inv_scale = torch.exp(-s)
    use_lo = y < 0.5
    ly = torch.log(torch.clamp(y, min=TINY))
    l1y = torch.log(torch.clamp(1.0 - y, min=TINY))
    x = torch.zeros_like(y)
    lo = torch.full_like(y, -SPAN)
    hi = torch.full_like(y, SPAN)
    dxold = torch.full_like(y, 2.0 * SPAN)
    live = torch.ones_like(y, dtype=torch.bool)
    count = torch.zeros_like(y, dtype=torch.int64)
    for _ in range(n_iters):
        count += live
        sg = torch.sigmoid((x[..., None] - mu) * inv_scale)
        cdf = _component_sum(pi * sg)
        pdf = _component_sum(pi * inv_scale * sg * (1.0 - sg))
        fraw = cdf - y
        lo = torch.where(fraw < 0, x, lo)
        hi = torch.where(fraw >= 0, x, hi)
        c = torch.clamp(cdf, TINY, 1.0 - 1.0e-7)
        f = torch.where(use_lo, torch.log(c) - ly, l1y - torch.log1p(-c))
        df = torch.clamp(torch.where(use_lo, pdf / c, pdf / (1.0 - c)), min=TINY)
        dx = f / df
        xn = x - dx
        use_bis = ((xn <= lo) | (xn >= hi)
                   | (torch.abs(2.0 * f) > torch.abs(dxold * df))
                   | ~torch.isfinite(xn))
        done = (torch.abs(dx) <= XTOL) | ((hi - lo) <= XTOL)
        live &= ~done
        dx = torch.where(use_bis, (hi - lo) * 0.5, dx)
        xn = torch.where(use_bis, (lo + hi) * 0.5, xn)
        x = torch.where(done, x, xn)
        dxold = torch.where(done, torch.zeros_like(dx), dx)
    if evaluations is not None:
        evaluations.append(count)
    return x


def mix_log_cdf_inverse_reference(y, logpi, mu, s, n_iters: int = N_ITERS):
    """The plain version: (x, per-sample logdet of the inverse)."""
    x = _newton_solve(y, logpi, mu, s, n_iters)
    return x, -sum_except_batch(mix_logistic_logpdf(x, logpi, mu, s))


def mix_log_cdf_inverse(y, logpi, mu, s):
    """Inverse of y = MixLogisticCDF(x): (x, per-sample logdet (B,)).

    ``y`` is (B, ...) and the mixture tensors (..., K), ``nf_tpu``'s
    layout.  The plain Newton on a CPU tensor; on a CUDA tensor the kernel,
    which takes any K."""
    if y.device.type == "cpu":
        return mix_log_cdf_inverse_reference(y, logpi, mu, s)
    B, K = y.shape[0], logpi.shape[-1]
    x, ld = cuda_mixlogcdf.MixLogCdfInverse.apply(
        y.reshape(B, -1), logpi.reshape(B, -1, K), mu.reshape(B, -1, K), s.reshape(B, -1, K))
    return x.reshape(y.shape), ld


# --------------------------------------------------------------------------
# logit space (fused MixLogCDF -> Logit)
# --------------------------------------------------------------------------
def _mix_logit_parts(x, logpi, mu, s):
    """u = log mixCDF(x), v = log(1 - mixCDF(x)), logpdf — all stable."""
    z = (x[..., None] - mu) * torch.exp(-s)
    u = torch.logsumexp(logpi + F.logsigmoid(z), dim=-1)
    v = torch.logsumexp(logpi + F.logsigmoid(-z), dim=-1)
    logpdf = torch.logsumexp(logpi + (z - s - 2.0 * F.softplus(z)), dim=-1)
    return u, v, logpdf


def mix_log_cdf_logit_forward(x, logpi, mu, s):
    """y = logit(MixLogisticCDF(x)) and the per-sample log-det."""
    u, v, logpdf = _mix_logit_parts(x, logpi, mu, s)
    return u - v, sum_except_batch(logpdf - u - v)


def mix_log_cdf_logit_inverse(y, logpi, mu, s, n_iters: int = N_ITERS):
    """Inverse of logit(MixLogisticCDF(x)) = y with its per-sample log-det."""
    x = torch.zeros_like(y)
    lo = torch.full_like(y, -SPAN)
    hi = torch.full_like(y, SPAN)
    dxold = torch.full_like(y, 2.0 * SPAN)
    for _ in range(n_iters):
        u, v, logpdf = _mix_logit_parts(x, logpi, mu, s)
        f = (u - v) - y
        lo = torch.where(f < 0, x, lo)
        hi = torch.where(f >= 0, x, hi)
        df = torch.clamp(torch.exp(logpdf - u - v), min=TINY)
        dx = f / df
        xn = x - dx
        use_bis = ((xn <= lo) | (xn >= hi)
                   | (torch.abs(2.0 * f) > torch.abs(dxold * df))
                   | ~torch.isfinite(xn))
        done = (torch.abs(dx) <= XTOL) | ((hi - lo) <= XTOL)
        dx = torch.where(use_bis, (hi - lo) * 0.5, dx)
        xn = torch.where(use_bis, (lo + hi) * 0.5, xn)
        x = torch.where(done, x, xn)
        dxold = torch.where(done, torch.zeros_like(dx), dx)
    u, v, logpdf = _mix_logit_parts(x, logpi, mu, s)
    return x, -sum_except_batch(logpdf - u - v)
