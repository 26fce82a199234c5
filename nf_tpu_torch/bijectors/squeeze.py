"""Volume-preserving squeeze / unsqueeze bijectors, of (B, D) vectors and
of NHWC maps, and the flatten (counterpart of
``nf_tpu/bijectors/squeeze.py``); log-det 0."""
from __future__ import annotations

import math

import torch

from ..core.bijector import Bijector
from ..ops import squeeze as sq


def _zeros(x):
    return torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)


def _squeeze(z, odd):
    return torch.cat(sq.squeeze2d(z, odd), dim=-1)


def _unsqueeze(z, odd):
    h = z.shape[-1] // 2
    return sq.unsqueeze2d(z[..., :h], z[..., h:], odd)


def _squeeze1d(z, odd):
    return torch.cat(sq.squeeze1d(z, odd), dim=1)


def _unsqueeze1d(z, odd):
    h = z.shape[1] // 2
    return sq.unsqueeze1d(z[:, :h], z[:, h:], odd)


class Squeeze1d(Bijector):
    """(B, D) -> (B, D): the even entries, then the odd ones."""

    def __init__(self, odd: bool = False):
        super().__init__()
        self.odd = odd

    def forward(self, z):
        return _squeeze1d(z, self.odd), _zeros(z)

    def inverse(self, z):
        return _unsqueeze1d(z, self.odd), _zeros(z)


class Unsqueeze1d(Bijector):
    """The inverse of ``Squeeze1d``: (B, D) halves interleaved again."""

    def __init__(self, odd: bool = False):
        super().__init__()
        self.odd = odd

    def forward(self, z):
        return _unsqueeze1d(z, self.odd), _zeros(z)

    def inverse(self, z):
        return _squeeze1d(z, self.odd), _zeros(z)


class Squeeze2d(Bijector):
    """(B,H,W,C) -> (B,H/2,W/2,4C)."""

    def __init__(self, odd: bool = False):
        super().__init__()
        self.odd = odd

    def forward(self, z):
        return _squeeze(z, self.odd), _zeros(z)

    def inverse(self, z):
        return _unsqueeze(z, self.odd), _zeros(z)


class Unsqueeze2d(Bijector):
    """(B,H,W,4C) -> (B,2H,2W,C)."""

    def __init__(self, odd: bool = False):
        super().__init__()
        self.odd = odd

    def forward(self, z):
        return _unsqueeze(z, self.odd), _zeros(z)

    def inverse(self, z):
        return _squeeze(z, self.odd), _zeros(z)


class Flatten(Bijector):
    """(B, *dims) <-> (B, prod(dims)); log-det 0.  MAF's flattened-pixel
    image variant runs its stack between ``Flatten`` and
    ``Inverted(Flatten)``."""

    def __init__(self, dims):
        super().__init__()
        self.dims = tuple(dims)
        self.flat_dim = math.prod(self.dims)

    def forward(self, z):
        return z.reshape(z.shape[0], self.flat_dim), _zeros(z)

    def inverse(self, z):
        return z.reshape((z.shape[0],) + self.dims), _zeros(z)
