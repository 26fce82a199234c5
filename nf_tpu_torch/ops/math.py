"""Shared flow math (counterpart of ``nf_tpu/ops/math.py``)."""
from __future__ import annotations

import math

import torch


def sum_except_batch(x: torch.Tensor) -> torch.Tensor:
    """Reduce all axes but the leading batch axis -> (B,)."""
    return x.reshape(x.shape[0], -1).sum(dim=1)


def standard_normal_logprob(z: torch.Tensor) -> torch.Tensor:
    """log N(z; 0, I) summed over non-batch dims -> (B,)."""
    d = z.reshape(z.shape[0], -1)
    return -0.5 * (d.shape[1] * math.log(2.0 * math.pi) + (d * d).sum(dim=1))
