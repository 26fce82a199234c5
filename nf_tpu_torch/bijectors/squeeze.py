"""Volume-preserving squeeze / unsqueeze bijectors, NHWC (counterpart of
``nf_tpu/bijectors/squeeze.py``); log-det 0."""
from __future__ import annotations

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
