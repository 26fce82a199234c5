"""Primitive conditioner layers (counterpart of ``nf_tpu/nets/layers.py``):
dense with optional weight norm, and standard (non-flow) batch norm.

Layout: weights are PyTorch's ``(out, in)``, where ``nf_tpu`` keeps
``(in, out)``.  The weight norm is the same parameterization: per-INPUT
feature norms, ``g`` of shape ``(in,)``, the norm taken over the out axis
(dim 0 here, axis 1 in ``nf_tpu``) and the eps added to the norm,
``w = v * g / (||v|| + 1e-5)``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .core import Net

_WN_EPS = 1.0e-5
_TRAINING = "training lands in a later slice"


def uniform(generator: torch.Generator, shape, bound: float, device) -> torch.Tensor:
    """U(-bound, bound) drawn from ``generator`` on its own device, then
    moved to ``device``."""
    u = torch.rand(shape, generator=generator, device=generator.device,
                   dtype=torch.float32)
    return ((2.0 * u - 1.0) * bound).to(device)


class Dense(Net):
    """y = x @ W.T + b with optional weight-norm parameterization."""

    def __init__(self, in_features: int, out_features: int,
                 weight_norm: bool = True, device=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.weight_norm = weight_norm
        kw = dict(device=device, dtype=torch.float32)
        if weight_norm:
            self.g = nn.Parameter(torch.ones(in_features, **kw))
            self.v = nn.Parameter(torch.zeros(out_features, in_features, **kw))
        else:
            self.w = nn.Parameter(torch.zeros(out_features, in_features, **kw))
        self.b = nn.Parameter(torch.zeros(out_features, **kw))

    @torch.no_grad()
    def init(self, generator):
        bound = math.sqrt(1.0 / self.in_features)
        dev = self.b.device
        w = uniform(generator, (self.out_features, self.in_features), bound, dev)
        self.b.copy_(uniform(generator, (self.out_features,), bound, dev))
        if self.weight_norm:
            g = torch.linalg.vector_norm(w, dim=0)
            self.g.copy_(g)
            self.v.copy_(w / (g[None, :] + _WN_EPS))
        else:
            self.w.copy_(w)

    def weight(self) -> torch.Tensor:
        """The effective (out, in) weight."""
        if self.weight_norm:
            vnorm = torch.linalg.vector_norm(self.v, dim=0)
            return self.v * (self.g / (vnorm + _WN_EPS))[None, :]
        return self.w

    def forward(self, x):
        return F.linear(x, self.weight(), self.b)


class BatchNormNet(Net):
    """Standard batch norm over all-but-channel axes (channel last); eval
    mode uses ``rsqrt(running_var + eps)``."""

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1.0e-5, device=None):
        super().__init__()
        self.num_features = num_features
        self.momentum = momentum
        self.eps = eps
        kw = dict(device=device, dtype=torch.float32)
        self.gamma = nn.Parameter(torch.ones(num_features, **kw))
        self.beta = nn.Parameter(torch.zeros(num_features, **kw))
        self.register_buffer("running_mean", torch.zeros(num_features, **kw))
        self.register_buffer("running_var", torch.ones(num_features, **kw))

    @torch.no_grad()
    def init(self, generator):
        self.gamma.fill_(1.0)
        self.beta.zero_()
        self.running_mean.zero_()
        self.running_var.fill_(1.0)

    def forward(self, x):
        if self.training:
            raise NotImplementedError(_TRAINING)
        y = (x - self.running_mean) * torch.rsqrt(self.running_var + self.eps)
        return y * self.gamma + self.beta
