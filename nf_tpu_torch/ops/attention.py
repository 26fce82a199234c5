"""Scaled dot-product attention over (batch * heads, L, D) slices
(counterpart of ``nf_tpu/ops/pallas/attention.py``).

``attention_reference`` is the plain version: f32 scores ``q k^T / sqrt(D)``,
a max-subtracted softmax over the keys, then the weighted sum of ``v``.
``attention`` is the dispatcher: one token returns ``v`` (the softmax of
one score is 1), a CPU tensor takes the plain version, and a CUDA tensor
goes to the hand-written kernel (``ops/cuda/attention.py``), which raises
where it does not cover the shape.  The caller (``nets/gated.py``) permutes
the roles as ``nf_tpu`` does.
"""
from __future__ import annotations

import math

import torch

from . import precision as pm
from .cuda import attention as cuda_attention


def attention_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Standard attention, unfused: (BH, L, D) -> (BH, L, D)."""
    scores = pm.matmul(q, k.transpose(1, 2)) / math.sqrt(q.shape[-1])
    return pm.matmul(torch.softmax(scores, dim=-1), v)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(D)) v over (BH, L, D) slices."""
    if q.shape[-2] == 1:
        return v
    if q.device.type == "cpu":
        return attention_reference(q, k, v)
    return cuda_attention.AttentionFwd.apply(q, k, v)
