"""Logistic-mixture CDF fused with a logit (the Flow++ inner transform);
counterpart of ``nf_tpu/bijectors/mixlogcdf.py``'s log-space variant.

``y = logit(MixLogisticCDF(x))`` computed as ``u - v`` with ``u = log CDF``
and ``v = log(1 - CDF)``, log-det ``logpdf - u - v``: exact in both tails,
no clamp.  The inverse is the fixed-trip bracket-safeguarded Newton
(rtsafe) in logit space on ``[-SPAN, SPAN]`` with a per-element freeze
once converged.  The constants equal ``nf_tpu``'s, and the CUDA Flow++
kernel (``csrc/fused_flowpp.cu``) uses the same.  Mixture components sit
on the LAST axis.  The probability-space ``mix_cdf`` / ``_newton_solve``
come with the image Flow++ slice.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.math import sum_except_batch

SPAN = 1.0e3
N_ITERS = 24
XTOL = 1.0e-5   # x-space convergence freeze
TINY = 1.0e-38  # a subnormal in f32: the CUDA build must not flush to zero


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
