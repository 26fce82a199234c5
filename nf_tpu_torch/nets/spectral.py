"""Lipschitz-constrained layers for invertible residual blocks (counterpart
of ``nf_tpu/nets/spectral.py``), eval mode.

* ``SpectralNormDense``: a dense layer whose weight is capped to spectral
  norm ``coeff``.  Its layout is ``nf_tpu``'s: ``w_bar`` is ``(in, out)``
  and ``y = x @ w + b``.  The power-iteration vectors ``u`` (out,) and
  ``v`` (in,) are buffers, warm-started at init by 10 power iterations.
  Eval reuses them: ``sigma = u . (w_bar^T v)``, ``scale = coeff / (sigma
  + eps)``, and ``w = w_bar * scale`` only where ``scale < 1``.
* ``LipSwish``: ``x * sigmoid(beta x) / 1.1`` with a learnable ``beta`` of
  shape (1,).

The training-mode power iteration lands with the training slice;
``SpectralNormConv2d`` with the image slice.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from .core import Net
from .layers import _TRAINING, uniform


def _l2normalize(v, eps: float = 1e-12):
    return v / (torch.linalg.vector_norm(v) + eps)


class SpectralNormDense(Net):
    """Dense layer (in, out) with coeff-capped spectral norm."""

    def __init__(self, in_features: int, out_features: int, coeff: float = 0.97,
                 eps: float = 1.0e-5, power_iterations: int = 1,
                 init_power_iterations: int = 10, device=None):
        super().__init__()
        self.in_features = in_features
        self.out_features = out_features
        self.coeff = coeff
        self.eps = eps
        self.power_iterations = power_iterations
        self.init_power_iterations = init_power_iterations
        kw = dict(device=device, dtype=torch.float32)
        self.w_bar = nn.Parameter(torch.zeros(in_features, out_features, **kw))
        self.b = nn.Parameter(torch.zeros(out_features, **kw))
        self.register_buffer("u", torch.zeros(out_features, **kw))
        self.register_buffer("v", torch.zeros(in_features, **kw))

    @torch.no_grad()
    def init(self, generator):
        bound = math.sqrt(1.0 / self.in_features)
        dev = self.b.device
        w = uniform(generator, (self.in_features, self.out_features), bound, dev)
        self.w_bar.copy_(w)
        self.b.copy_(uniform(generator, (self.out_features,), bound, dev))
        u = torch.randn(self.out_features, generator=generator, device=generator.device)
        v = torch.randn(self.in_features, generator=generator, device=generator.device)
        u, v = _l2normalize(u.to(dev)), _l2normalize(v.to(dev))
        for _ in range(self.init_power_iterations):
            v = _l2normalize(w @ u)
            u = _l2normalize(w.T @ v)
        self.u.copy_(u)
        self.v.copy_(v)

    def weight(self) -> torch.Tensor:
        """The effective (in, out) weight, eval mode."""
        if self.training:
            raise NotImplementedError(_TRAINING)
        sigma = self.u @ (self.w_bar.T @ self.v)
        scale = self.coeff / (sigma + self.eps)
        return torch.where(scale < 1.0, self.w_bar * scale, self.w_bar)

    def forward(self, x):
        return x @ self.weight() + self.b


class LipSwish(Net):
    def __init__(self, device=None):
        super().__init__()
        self.beta = nn.Parameter(torch.ones(1, device=device, dtype=torch.float32))

    @torch.no_grad()
    def init(self, generator):
        self.beta.fill_(1.0)

    def forward(self, x):
        return x * torch.sigmoid(self.beta * x) / 1.1
