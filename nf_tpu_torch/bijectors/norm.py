"""ActNorm and invertible flow-BatchNorm (counterpart of
``nf_tpu/bijectors/norm.py``), eval mode.

ActNorm is ``y = (x - bias) * exp(-log_scale)``.  Its data-dependent init
(``nf_tpu``'s ``dd_init``) comes with the training slice; serving loads
initialized parameters, and ``initialized`` is kept as a bool buffer as
``nf_tpu`` keeps it in state.

BatchNorm eval normalizes by the running statistics with
``rsqrt(running_var)`` and NO eps (the eps is folded into ``running_var``
when the batch statistics are taken in training).  A non-affine BatchNorm
keeps its identity ``log_gamma`` / ``beta`` as buffers, as ``nf_tpu`` keeps
them in state.  Layout: channel axis last.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.bijector import Bijector
from ..nets.layers import _TRAINING


def _num_pixels(x):
    """Spatial multiplicity of each channel entry (1 for (B, D) data)."""
    n = 1
    for s in x.shape[1:-1]:
        n *= s
    return n


class ActNorm(Bijector):
    """y = (x - bias) * exp(-log_scale); logdet = -sum(log_scale) * n_pixels."""

    def __init__(self, num_channels: int, eps: float = 1.0e-5, device=None):
        super().__init__()
        self.num_channels = num_channels
        self.eps = eps
        kw = dict(device=device, dtype=torch.float32)
        self.log_scale = nn.Parameter(torch.zeros(num_channels, **kw))
        self.bias = nn.Parameter(torch.zeros(num_channels, **kw))
        self.register_buffer("initialized",
                             torch.zeros((), dtype=torch.bool, device=device))

    @torch.no_grad()
    def init(self, generator):
        self.log_scale.zero_()
        self.bias.zero_()
        self.initialized.fill_(False)

    def _logdet(self, x, sign):
        return (sign * self.log_scale.sum() * _num_pixels(x)).expand(x.shape[0])

    def forward(self, x):
        y = (x - self.bias) * torch.exp(-self.log_scale)
        return y, self._logdet(x, -1.0)

    def inverse(self, y):
        x = y * torch.exp(self.log_scale) + self.bias
        return x, self._logdet(y, 1.0)


class BatchNorm(Bijector):
    def __init__(self, num_channels: int, momentum: float = 0.1,
                 eps: float = 1.0e-5, affine: bool = True, device=None):
        super().__init__()
        self.num_channels = num_channels
        self.momentum = momentum
        self.eps = eps
        self.affine = affine
        kw = dict(device=device, dtype=torch.float32)
        c = num_channels
        if affine:
            self.log_gamma = nn.Parameter(torch.zeros(c, **kw))
            self.beta = nn.Parameter(torch.zeros(c, **kw))
        else:
            self.register_buffer("log_gamma", torch.zeros(c, **kw))
            self.register_buffer("beta", torch.zeros(c, **kw))
        self.register_buffer("running_mean", torch.zeros(c, **kw))
        self.register_buffer("running_var", torch.ones(c, **kw))
        self.register_buffer("batch_mean", torch.zeros(c, **kw))
        self.register_buffer("batch_var", torch.ones(c, **kw))

    @torch.no_grad()
    def init(self, generator):
        for name in ("log_gamma", "beta", "running_mean", "batch_mean"):
            getattr(self, name).zero_()
        self.running_var.fill_(1.0)
        self.batch_var.fill_(1.0)

    def _logdet(self, x, sign):
        ld = (self.log_gamma - 0.5 * torch.log(self.running_var)).sum()
        return (sign * ld * _num_pixels(x)).expand(x.shape[0])

    def forward(self, x):
        if self.training:
            raise NotImplementedError(_TRAINING)
        y = (x - self.running_mean) * torch.rsqrt(self.running_var)
        y = y * torch.exp(self.log_gamma) + self.beta
        return y, self._logdet(x, 1.0)

    def inverse(self, y):
        if self.training:
            raise NotImplementedError(_TRAINING)
        x = (y - self.beta) * torch.exp(-self.log_gamma)
        x = x * torch.sqrt(self.running_var) + self.running_mean
        return x, self._logdet(y, -1.0)
