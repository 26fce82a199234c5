"""Flow++ conditioner blocks (counterpart of ``nf_tpu/nets/gated.py``):
gated dense and conv layers, full-shape LayerNorm and gated self-attention.

* ``GatedLinear`` / ``GatedConv2d``: ``y = op(elu([x, -x]))`` with ``op`` a
  dense layer or an NHWC 3x3 conv (no weight norm, in == out features),
  then ``x + elu(y) * sigmoid(elu(-y))``: the second ``elu([y, -y])``
  split into its halves.
* ``LayerNormNet``: normalizes over ALL non-batch axes (a feature vector,
  or an image's (h, w, f)) with a full-shape affine, eps 1e-5.
* ``GatedAttn``: V / K / Q from one projection of ``x + pos_emb`` over the
  flattened spatial axis (L tokens, one for 1-D data), in that v | k | q
  order, split into heads as (B, L, h, D) -> (B, h, L, D).  ``nf_tpu``
  attends with the roles permuted, ``A = attention(query=K, key=V,
  value=Q)`` (``ops/attention.py``: the CUDA kernel on the card), then a
  gated output projection and a residual.  At one token attention is the
  identity on its value, so ``A = Q``.  The raw parameters keep
  ``nf_tpu``'s ``(in, out)`` layout: ``w_qkv`` (C, 3f), ``w_out`` (f, 2C).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import precision as pm
from ..ops.attention import attention
from .core import Net
from .layers import Conv2d, Dense, uniform


class _Gated(Net):
    """``x + elu(y) * sigmoid(elu(-y))`` with ``y = op(elu([x, -x]))``,
    the features on the last axis."""

    def __init__(self, features: int, op: Net):
        super().__init__()
        self.features = features
        self.op = op

    def forward(self, x):
        y = self.op(F.elu(torch.cat([x, -x], dim=-1)))
        return x + F.elu(y) * torch.sigmoid(F.elu(-y))


class GatedLinear(_Gated):
    def __init__(self, features: int, device=None):
        super().__init__(features, Dense(features * 2, features, weight_norm=False,
                                         device=device))


class GatedConv2d(_Gated):
    def __init__(self, features: int, device=None):
        super().__init__(features, Conv2d(features * 2, features, 3, weight_norm=False,
                                          device=device))


class LayerNormNet(Net):
    """LayerNorm over all non-batch axes with full-shape affine."""

    def __init__(self, shape, eps: float = 1.0e-5, device=None):
        super().__init__()
        self.shape = tuple(shape)
        self.eps = eps
        kw = dict(device=device, dtype=torch.float32)
        self.gamma = nn.Parameter(torch.ones(self.shape, **kw))
        self.beta = nn.Parameter(torch.zeros(self.shape, **kw))

    @torch.no_grad()
    def init(self, generator):
        self.gamma.fill_(1.0)
        self.beta.zero_()

    def forward(self, x):
        axes = tuple(range(1, x.dim()))
        mean = x.mean(dim=axes, keepdim=True)
        var = ((x - mean) ** 2).mean(dim=axes, keepdim=True)
        return (x - mean) * torch.rsqrt(var + self.eps) * self.gamma + self.beta


class GatedAttn(Net):
    """Gated multi-head self-attention over the flattened spatial axis."""

    def __init__(self, in_shape, filters: int = 8, heads: int = 4, device=None):
        super().__init__()
        if filters % heads != 0:
            raise ValueError(f"filters ({filters}) must be a multiple of heads ({heads})")
        self.in_shape = tuple(in_shape)
        self.channels = self.in_shape[-1]
        self.filters = filters
        self.heads = heads
        c, f = self.channels, filters
        kw = dict(device=device, dtype=torch.float32)
        self.w_qkv = nn.Parameter(torch.zeros(c, 3 * f, **kw))
        self.b_qkv = nn.Parameter(torch.zeros(3 * f, **kw))
        self.w_out = nn.Parameter(torch.zeros(f, 2 * c, **kw))
        self.b_out = nn.Parameter(torch.zeros(2 * c, **kw))
        self.pos_emb = nn.Parameter(torch.zeros(self.in_shape, **kw))

    @torch.no_grad()
    def init(self, generator):
        c, f = self.channels, self.filters
        dev = self.w_qkv.device
        self.w_qkv.copy_(uniform(generator, (c, 3 * f), math.sqrt(1.0 / c), dev))
        self.b_qkv.copy_(uniform(generator, (3 * f,), math.sqrt(1.0 / c), dev))
        self.w_out.copy_(uniform(generator, (f, 2 * c), math.sqrt(1.0 / f), dev))
        self.b_out.copy_(uniform(generator, (2 * c,), math.sqrt(1.0 / f), dev))
        pos = torch.randn(self.in_shape, generator=generator, device=generator.device)
        self.pos_emb.copy_(0.01 * pos.to(dev))

    def forward(self, x):
        B, C, f, h = x.shape[0], self.channels, self.filters, self.heads
        D = f // h
        xr = (x + self.pos_emb).reshape(B, -1, C)                  # (B, L, C)
        L = xr.shape[1]
        v_, k_, q_ = (pm.matmul(xr, self.w_qkv) + self.b_qkv).split(f, dim=-1)

        def heads_of(t):   # (B, L, f) -> (B * h, L, D)
            return t.reshape(B, L, h, D).transpose(1, 2).reshape(B * h, L, D)

        A = attention(heads_of(k_), heads_of(v_), heads_of(q_))
        A = A.reshape(B, h, L, D).transpose(1, 2).reshape(B, L, f)
        y = pm.matmul(A, self.w_out) + self.b_out                             # (B, L, 2C)
        out = y[..., :C] * torch.sigmoid(y[..., C:])
        return x + out.reshape(x.shape)
