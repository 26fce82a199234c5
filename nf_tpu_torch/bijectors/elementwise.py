"""The logit input transform (counterpart of
``nf_tpu/bijectors/elementwise.py``'s ``Logit``)."""
from __future__ import annotations

import math

import torch

from ..core.bijector import Bijector
from ..ops import math as fm


def _size(x) -> int:
    """Elements per sample."""
    return x[0].numel()


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
