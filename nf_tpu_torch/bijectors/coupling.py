"""Affine coupling (counterpart of ``nf_tpu/bijectors/coupling.py``), 1-D.

``s = tanh(raw_s) * s_log_scale + s_bias`` with a learned scalar gain and
bias; forward ``z0' = z0 * exp(s) + t``, logdet ``sum(s)``.  1-D splits use
stride-2 slicing (even / odd features), the odd coupling swapping which
half is transformed.  The plain math below is what ``nf_tpu`` runs at
D = 2 too: its fused coupling kernel only takes halves 128 wide.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.bijector import Bijector
from ..nets.conditioners import MLP
from ..ops.math import sum_except_batch


def split1d(z, odd: bool = False):
    """(B, D) -> even-index and odd-index halves (works for odd D)."""
    z0, z1 = z[:, 0::2], z[:, 1::2]
    return (z1, z0) if odd else (z0, z1)


def merge1d(z0, z1, odd: bool = False):
    if odd:
        z0, z1 = z1, z0
    out = z0.new_empty((z0.shape[0], z0.shape[1] + z1.shape[1]))
    out[:, 0::2] = z0
    out[:, 1::2] = z1
    return out


class _CouplingBase(Bijector):
    """Split / merge plumbing; subclasses implement ``_transform`` /
    ``_inverse_transform`` over (z0, z1) with z1 the conditioning half."""

    def __init__(self, dims, masking: str = "checkerboard", odd: bool = False):
        super().__init__()
        self.dims = tuple(dims)
        self.masking = masking
        self.odd = odd
        if len(self.dims) != 1:
            raise NotImplementedError(
                "image (checkerboard / channelwise) couplings land with the "
                "image tier")

    def half_dims(self):
        """Sizes of the transformed half (z0) and conditioning half (z1)."""
        d = self.dims[0]
        n_even, n_odd = (d + 1) // 2, d // 2
        return (n_odd, n_even) if self.odd else (n_even, n_odd)

    def forward(self, x):
        z0, z1 = split1d(x, self.odd)
        z0, ld = self._transform(z0, z1)
        return merge1d(z0, z1, self.odd), ld

    def inverse(self, y):
        y0, y1 = split1d(y, self.odd)
        y0, ld = self._inverse_transform(y0, y1)
        return merge1d(y0, y1, self.odd), ld


class AffineCoupling(_CouplingBase):
    """z0' = z0 * exp(s) + t, with s = tanh(raw_s) * s_log_scale + s_bias."""

    def __init__(self, dims, masking="checkerboard", odd=False,
                 base_filters=32, device=None):
        super().__init__(dims, masking, odd)
        self.out_chs, in_chs = self.half_dims()
        self.net = MLP(in_chs, 2 * self.out_chs, base_filters=base_filters,
                       device=device)
        kw = dict(device=device, dtype=torch.float32)
        self.s_log_scale = nn.Parameter(torch.zeros(1, **kw))
        self.s_bias = nn.Parameter(torch.zeros(1, **kw))

    @torch.no_grad()
    def init(self, generator):
        self.net.init(generator)
        for p in (self.s_log_scale, self.s_bias):
            z = torch.randn(1, generator=generator, device=generator.device)
            p.copy_(z * 0.01)

    def _scale_shift(self, z1):
        raw = self.net(z1)
        t, raw_s = raw[:, :self.out_chs], raw[:, self.out_chs:]
        s = torch.tanh(raw_s) * self.s_log_scale + self.s_bias
        return s, t

    def _transform(self, z0, z1):
        s, t = self._scale_shift(z1)
        return z0 * torch.exp(s) + t, sum_except_batch(s)

    def _inverse_transform(self, y0, y1):
        s, t = self._scale_shift(y1)
        return (y0 - t) * torch.exp(-s), -sum_except_batch(s)
