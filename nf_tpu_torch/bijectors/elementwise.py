"""Parameter-free elementwise bijectors with exact log-dets (counterpart
of ``nf_tpu/bijectors/elementwise.py``): ``Identity``, ``Sigmoid``,
``Logit``, ``Tanh`` and ``Arctanh``, with ``nf_tpu``'s clamps."""
from __future__ import annotations

import math

import torch

from ..core.bijector import Bijector
from ..ops import math as fm


def _size(x) -> int:
    """Elements per sample."""
    return x[0].numel()


def _zeros(x) -> torch.Tensor:
    return torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)


class Identity(Bijector):
    def forward(self, x):
        return x, _zeros(x)

    def inverse(self, y):
        return y, _zeros(y)


class Sigmoid(Bijector):
    """y = sigmoid(x); the inverse clamps y to [1e-8, 1 - 1e-8] before the
    logit."""

    def forward(self, x):
        return torch.reciprocal(1.0 + torch.exp(-x)), fm.sum_except_batch(
            fm.log_deriv_sigmoid(x))

    def inverse(self, y):
        y = torch.clamp(y, 1.0e-8, 1.0 - 1.0e-8)
        return fm.logit(y), fm.sum_except_batch(fm.log_deriv_logit(y))


class Tanh(Bijector):
    """y = tanh(x); the inverse's log-det is taken before y is clamped to
    |y| <= 1 - 1e-8, as ``nf_tpu`` takes it."""

    def forward(self, x):
        return torch.tanh(x), fm.sum_except_batch(fm.log_deriv_tanh(x))

    def inverse(self, y):
        ld = fm.sum_except_batch(fm.log_deriv_arctanh(y))
        return torch.atanh(torch.clamp(y, -1.0 + 1.0e-8, 1.0 - 1.0e-8)), ld


class Arctanh(Bijector):
    """y = arctanh(x), x clamped to |x| <= 1 - 1e-8 after the log-det."""

    def forward(self, x):
        ld = fm.sum_except_batch(fm.log_deriv_arctanh(x))
        return torch.atanh(torch.clamp(x, -1.0 + 1.0e-8, 1.0 - 1.0e-8)), ld

    def inverse(self, y):
        return torch.tanh(y), fm.sum_except_batch(fm.log_deriv_tanh(y))


class Logit(Bijector):
    """y = logit(x).

    ``compress=False`` (reference parity): y = logit(clamp(x, eps, 1-eps)),
    which collapses every pixel below eps onto eps.  ``compress=True`` (the
    image builders' default): y = logit(eps + (1-2eps) x), a bijection of
    [0, 1] whose squash is paid for in the log-det, + d log(1-2eps)."""

    def __init__(self, eps: float = 1.0e-5, compress: bool = False):
        super().__init__()
        self.eps = eps
        self.compress = compress

    def forward(self, x):
        if self.compress:
            scale = 1.0 - 2.0 * self.eps
            x = self.eps + scale * x
            ld = fm.sum_except_batch(fm.log_deriv_logit(x)) + _size(x) * math.log(scale)
            return fm.logit(x), ld
        x = torch.clamp(x, self.eps, 1.0 - self.eps)
        return fm.logit(x), fm.sum_except_batch(fm.log_deriv_logit(x))

    def inverse(self, y):
        s = torch.sigmoid(y)
        ld = fm.sum_except_batch(fm.log_deriv_sigmoid(y))
        if self.compress:
            scale = 1.0 - 2.0 * self.eps
            return (s - self.eps) / scale, ld - _size(s) * math.log(scale)
        return s, ld
