"""ActNorm and invertible flow-BatchNorm (counterpart of
``nf_tpu/bijectors/norm.py``).

ActNorm is ``y = (x - bias) * exp(-log_scale)``.  ``dd_init`` sets bias to
the batch mean and log_scale to log(std + eps), std with ddof = 1, and
marks ``initialized`` (a bool buffer, as ``nf_tpu`` keeps it in state).

BatchNorm in training normalizes by the batch mean and ``varb`` = the
biased batch variance + eps, with gradients through both; it moves the
running statistics by ``momentum`` toward them and caches them (detached)
as ``batch_mean`` / ``batch_var``, which the training-mode inverse uses.
Eval normalizes by the running statistics with ``rsqrt(running_var)`` and
NO further eps (it is folded into ``running_var``).  A non-affine
BatchNorm keeps its identity ``log_gamma`` / ``beta`` as buffers, as
``nf_tpu`` keeps them in state.  Layout: channel axis last.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.bijector import Bijector, replaying
from ..nets.layers import batch_moments, update_running


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

    @torch.no_grad()
    def dd_init(self, x, generator=None):
        axes = tuple(range(x.dim() - 1))
        mean = x.mean(dim=axes)
        n = x.numel() // x.shape[-1]
        var = ((x - mean) ** 2).sum(dim=axes) / max(n - 1, 1)
        self.log_scale.copy_(torch.log(torch.sqrt(var) + self.eps))
        self.bias.copy_(mean)
        self.initialized.fill_(True)
        return self(x)[0]

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

    def _logdet(self, x, var, sign):
        ld = (self.log_gamma - 0.5 * torch.log(var)).sum()
        return (sign * ld * _num_pixels(x)).expand(x.shape[0])

    def forward(self, x):
        if self.training:
            mean, var, centered = batch_moments(x)
            var = var + self.eps
            if not replaying():
                update_running(self, mean, var)
                self.batch_mean.copy_(mean.detach())
                self.batch_var.copy_(var.detach())
        else:
            var, centered = self.running_var, x - self.running_mean
        y = centered * torch.rsqrt(var)
        y = y * torch.exp(self.log_gamma) + self.beta
        return y, self._logdet(x, var, 1.0)

    def inverse(self, y):
        if self.training:
            mean, var = self.batch_mean, self.batch_var
        else:
            mean, var = self.running_mean, self.running_var
        x = (y - self.beta) * torch.exp(-self.log_gamma)
        x = x * torch.sqrt(var) + mean
        return x, self._logdet(y, var, -1.0)
