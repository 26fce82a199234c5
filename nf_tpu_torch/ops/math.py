"""Shared flow math (counterpart of ``nf_tpu/ops/math.py``)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x); ``F.softplus`` returns x itself past x = 20, where
    the two agree in f32."""
    return F.softplus(x)


def log_deriv_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """log sigma'(x) = log sigma(x) + log(1 - sigma(x)) = x - 2*softplus(x)."""
    return x - 2.0 * F.softplus(x)


def deriv_sigmoid(x: torch.Tensor) -> torch.Tensor:
    return torch.exp(log_deriv_sigmoid(x))


def logit(x: torch.Tensor) -> torch.Tensor:
    return torch.log(x) - torch.log1p(-x)


def log_deriv_logit(x: torch.Tensor, eps: float = 1.0e-8) -> torch.Tensor:
    """log logit'(x), the inverse-function derivative of sigmoid, with x
    clamped to [eps, 1 - eps] first."""
    return -log_deriv_sigmoid(logit(torch.clamp(x, eps, 1.0 - eps)))


def deriv_tanh(x: torch.Tensor) -> torch.Tensor:
    """tanh'(x) = 1 - tanh(x)^2."""
    y = torch.tanh(x)
    return 1.0 - y * y


def log_cosh(x: torch.Tensor) -> torch.Tensor:
    """Numerically stable log cosh(x)."""
    s = torch.abs(x)
    return s + torch.log1p(torch.exp(-2.0 * s)) - math.log(2.0)


def log_deriv_tanh(x: torch.Tensor) -> torch.Tensor:
    """log tanh'(x) = log(1 - tanh(x)^2) = -2 log cosh(x)."""
    return -2.0 * log_cosh(x)


def log_deriv_arctanh(x: torch.Tensor, eps: float = 1.0e-8) -> torch.Tensor:
    """log arctanh'(x) = -log(1 - x^2), x clamped away from |x| = 1."""
    x = torch.clamp(x, -1.0 + eps, 1.0 - eps)
    return -(torch.log1p(-x) + torch.log1p(x))


def logistic_logpdf(x: torch.Tensor, mu: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """log pdf of Logistic(mu, exp(s)) at x (s is the log-scale)."""
    z = (x - mu) * torch.exp(-s)
    return z - s - 2.0 * F.softplus(z)


def logistic_logcdf(x: torch.Tensor, mu: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """log cdf of Logistic(mu, exp(s)) at x."""
    return F.logsigmoid((x - mu) * torch.exp(-s))


def mix_logistic_logpdf(x: torch.Tensor, logpi: torch.Tensor, mu: torch.Tensor,
                        s: torch.Tensor) -> torch.Tensor:
    """log pdf of a K-mixture of logistics at x (...); ``logpi``, ``mu``,
    ``s`` are (..., K) with logpi log-softmaxed over the last axis."""
    return torch.logsumexp(logpi + logistic_logpdf(x[..., None], mu, s), dim=-1)


def mix_logistic_logcdf(x: torch.Tensor, logpi: torch.Tensor, mu: torch.Tensor,
                        s: torch.Tensor) -> torch.Tensor:
    """log cdf of a K-mixture of logistics; the conventions of
    ``mix_logistic_logpdf``."""
    return torch.logsumexp(logpi + logistic_logcdf(x[..., None], mu, s), dim=-1)


def sum_except_batch(x: torch.Tensor) -> torch.Tensor:
    """Reduce all axes but the leading batch axis -> (B,)."""
    return x.reshape(x.shape[0], -1).sum(dim=1)


def standard_normal_logprob(z: torch.Tensor) -> torch.Tensor:
    """log N(z; 0, I) summed over non-batch dims -> (B,)."""
    d = z.reshape(z.shape[0], -1)
    return -0.5 * (d.shape[1] * math.log(2.0 * math.pi) + (d * d).sum(dim=1))
