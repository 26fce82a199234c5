"""Additive and affine coupling (counterpart of
``nf_tpu/bijectors/coupling.py``).  ``AdditiveCoupling`` (NICE):
``z0' = z0 + t(z1)``, volume preserving.

``s = tanh(raw_s) * s_log_scale + s_bias`` with a learned scalar gain and
bias; forward ``z0' = z0 * exp(s) + t``, logdet ``sum(s)``.  The split
follows ``nf_tpu``: 1-D data by stride-2 slicing (even / odd features),
NHWC images by the checkerboard (``ops/squeeze.py``'s (a, d) / (b, c)
cells) or channelwise split; ``odd`` swaps which half is transformed.  The
conditioner is an MLP for 1-D data and a ConvNet for images, its
channel-last output split into t (the first ``out_chs`` channels) and
raw_s (the rest).

The split, the conditioner and the merge are the spans ``coupling.split``,
``coupling.net`` and ``coupling.merge`` (``utils/tracing.py``).

The transform goes through ``ops/cuda/coupling.py``'s dispatchers on the
flattened halves: a half a multiple of 128 wide (every image coupling of
the zoo) runs the CUDA kernels on the card, with the analytic backward;
narrower halves (2-D density) take the plain math, as in ``nf_tpu``.

``compute_dtype="bfloat16"`` runs the conditioner in bf16; its output is
cast back to f32 before the flow math, so the transform, its log-det and
the kernels stay f32.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.bijector import Bijector
from ..nets.conditioners import MLP, ConvNet
from ..ops import squeeze as sq
from ..ops.cuda.coupling import coupling_fwd, coupling_inv
from ..utils.tracing import span


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


_SPLITS = {"checkerboard": (sq.checker_split, sq.checker_merge),
           "channelwise": (sq.channel_split, sq.channel_merge)}


class _CouplingBase(Bijector):
    """Split / merge plumbing; subclasses implement ``_transform`` /
    ``_inverse_transform`` over (z0, z1) with z1 the conditioning half."""

    def __init__(self, dims, masking: str = "checkerboard", odd: bool = False):
        super().__init__()
        self.dims = tuple(dims)
        self.masking = masking
        self.odd = odd
        if len(self.dims) == 1:
            self._split, self._merge = split1d, merge1d
        elif len(self.dims) == 3 and masking in _SPLITS:
            self._split, self._merge = _SPLITS[masking]
        else:
            raise ValueError(f"unsupported masking/dims: {masking}, {dims}")

    def half_dims(self):
        """Sizes of the transformed half (z0) and conditioning half (z1):
        features for 1-D data, channels for images."""
        if len(self.dims) == 1:
            d = self.dims[0]
            n_even, n_odd = (d + 1) // 2, d // 2
            return (n_odd, n_even) if self.odd else (n_even, n_odd)
        c = self.dims[2]
        if self.masking == "checkerboard":
            return 2 * c, 2 * c
        return c // 2, c - c // 2

    def forward(self, x):
        with span("coupling.split"):
            z0, z1 = self._split(x, self.odd)
        z0, ld = self._transform(z0, z1)
        with span("coupling.merge"):
            return self._merge(z0, z1, self.odd), ld

    def inverse(self, y):
        with span("coupling.split"):
            y0, y1 = self._split(y, self.odd)
        y0, ld = self._inverse_transform(y0, y1)
        with span("coupling.merge"):
            return self._merge(y0, y1, self.odd), ld


def _flat2d(x):
    return x.reshape(x.shape[0], -1)


def _conditioner(coupling, out_mult: int, base_filters: int, device, compute_dtype):
    """The net mapping z1 to ``out_mult`` x z0's channels: an MLP for 1-D
    data, a ConvNet for images."""
    coupling.out_chs, in_chs = coupling.half_dims()
    net = MLP if len(coupling.dims) == 1 else ConvNet
    return net(in_chs, out_mult * coupling.out_chs, base_filters=base_filters, device=device,
               compute_dtype=compute_dtype)


class AdditiveCoupling(_CouplingBase):
    """z0' = z0 + t(z1); log-det 0."""

    def __init__(self, dims, masking="checkerboard", odd=False,
                 base_filters=32, device=None, compute_dtype=None):
        super().__init__(dims, masking, odd)
        self.net = _conditioner(self, 1, base_filters, device, compute_dtype)

    def _transform(self, z0, z1):
        with span("coupling.net"):
            t = self.net(z1).to(torch.float32)
        return z0 + t, torch.zeros(z0.shape[0], dtype=torch.float32, device=z0.device)

    def _inverse_transform(self, y0, y1):
        with span("coupling.net"):
            t = self.net(y1).to(torch.float32)
        return y0 - t, torch.zeros(y0.shape[0], dtype=torch.float32, device=y0.device)


class AffineCoupling(_CouplingBase):
    """z0' = z0 * exp(s) + t, with s = tanh(raw_s) * s_log_scale + s_bias."""

    def __init__(self, dims, masking="checkerboard", odd=False,
                 base_filters=32, device=None, compute_dtype=None):
        super().__init__(dims, masking, odd)
        self.net = _conditioner(self, 2, base_filters, device, compute_dtype)
        kw = dict(device=device, dtype=torch.float32)
        self.s_log_scale = nn.Parameter(torch.zeros(1, **kw))
        self.s_bias = nn.Parameter(torch.zeros(1, **kw))

    @torch.no_grad()
    def init(self, generator):
        self.net.init(generator)
        for p in (self.s_log_scale, self.s_bias):
            z = torch.randn(1, generator=generator, device=generator.device)
            p.copy_(z * 0.01)

    def _shift_raw(self, z1):
        with span("coupling.net"):
            raw = self.net(z1).to(torch.float32)
        return _flat2d(raw[..., :self.out_chs]), _flat2d(raw[..., self.out_chs:])

    def _transform(self, z0, z1):
        t, raw_s = self._shift_raw(z1)
        y, ld = coupling_fwd(_flat2d(z0), t, raw_s, self.s_log_scale, self.s_bias)
        return y.reshape(z0.shape), ld

    def _inverse_transform(self, y0, y1):
        t, raw_s = self._shift_raw(y1)
        x, ld = coupling_inv(_flat2d(y0), t, raw_s, self.s_log_scale, self.s_bias)
        return x.reshape(y0.shape), ld
