"""Flow++ conditioner blocks (counterpart of ``nf_tpu/nets/gated.py``), 1-D:
gated dense layer, full-shape LayerNorm and gated self-attention.

* ``GatedLinear``: ``y = op(elu([x, -x]))``, then ``x + elu(y) *
  sigmoid(elu(-y))`` (in == out features).
* ``LayerNormNet``: normalizes over ALL non-batch axes with a full-shape
  affine, eps 1e-5.
* ``GatedAttn``: V / K / Q from one projection of ``x + pos_emb``; the
  reference attends with the roles permuted, ``A = attn(query=K, key=V,
  value=Q)``, then a gated output projection and a residual.  Its raw
  parameters keep ``nf_tpu``'s ``(in, out)`` layout: ``w_qkv`` (C, 3f) in
  v | k | q order, ``w_out`` (f, 2C).  At one token (L == 1, every 1-D
  density) attention is the identity on its value, so ``A = Q``; longer
  sequences come with the image Flow++ slice and its attention kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .core import Net
from .layers import Dense, uniform


class GatedLinear(Net):
    def __init__(self, features: int, device=None):
        super().__init__()
        self.features = features
        self.op = Dense(features * 2, features, weight_norm=False, device=device)

    def forward(self, x):
        y = self.op(F.elu(torch.cat([x, -x], dim=-1)))
        return x + F.elu(y) * torch.sigmoid(F.elu(-y))


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
        B, C, f = x.shape[0], self.channels, self.filters
        xr = (x + self.pos_emb).reshape(B, -1, C)                  # (B, L, C)
        if xr.shape[1] != 1:
            raise NotImplementedError("attention over more than one token lands "
                                      "with the image Flow++ slice")
        qkv = xr @ self.w_qkv + self.b_qkv                          # (B, 1, 3f)
        A = qkv[..., 2 * f:]            # softmax of one score is 1: A = Q
        y = A @ self.w_out + self.b_out                             # (B, 1, 2C)
        out = y[..., :C] * torch.sigmoid(y[..., C:])
        return x + out.reshape(x.shape)
