"""Lipschitz-constrained layers for invertible residual blocks (counterpart
of ``nf_tpu/nets/spectral.py``).

* ``SpectralNormDense``: a dense layer whose weight is capped to spectral
  norm ``coeff``.  Its layout is ``nf_tpu``'s: ``w_bar`` is ``(in, out)``
  and ``y = x @ w + b``.  The power-iteration vectors ``u`` (out,) and
  ``v`` (in,) are buffers, warm-started at init by 10 power iterations.
* ``SpectralNormConv2d``: a 3x3 SAME conv over NHWC with a capped spectral
  norm, ``w_bar`` stored HWIO as in ``nf_tpu``.  With ``spatial = (H, W)``
  the power iteration runs on the conv operator itself: ``u`` is an output
  featuremap ``(1, H, W, out)``, ``v`` an input one ``(1, H, W, in)``, both
  NHWC, ``v <- normalize(conv^T u)``, ``u <- normalize(conv v)`` with
  conv^T the conv's adjoint (``conv_transpose2d``), and ``sigma = sum(u *
  conv(w_bar, v))``.  Without ``spatial`` it iterates on the matricized
  kernel ``w_bar.reshape(-1, out).T`` in HWIO flatten order, ``u`` (out,)
  and ``v`` (kh kw in,).
* ``LipSwish``: ``x * sigmoid(beta x) / 1.1`` with a learnable ``beta`` of
  shape (1,).

Both spectral norms scale ``w = w_bar * coeff / (sigma + eps)`` only where
that factor is below 1, and the gradient flows through sigma into
``w_bar``.  In train mode a forward first runs ``power_iterations`` (1)
steps on the detached ``w_bar`` and writes ``u`` / ``v`` back; eval mode
(and ``weight()``) reuses the stored vectors, and so does the recompute of a
rematerialized forward (``core.bijector.replaying``).
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..core.bijector import replaying
from ..ops import precision as pm
from .core import Net
from .layers import uniform


def _l2normalize(v, eps: float = 1e-12):
    return v / (torch.linalg.vector_norm(v) + eps)


def _capped(w_bar, sigma, coeff: float, eps: float):
    scale = coeff / (sigma + eps)
    return torch.where(scale < 1.0, w_bar * scale, w_bar)


class _SpectralNorm(Net):
    """What both spectral norms share: the ``u`` / ``v`` buffers, their
    warm start at init and the power iteration of a train-mode forward.
    A subclass gives ``_iterate(w, u, v, n)``, ``weight()`` and
    ``_transform(w, x)``."""

    @torch.no_grad()
    def _init(self, generator, w, b_bound: float):
        dev = self.b.device
        self.w_bar.copy_(w)
        self.b.copy_(uniform(generator, tuple(self.b.shape), b_bound, dev))
        u = torch.randn(self.u.shape, generator=generator, device=generator.device)
        v = torch.randn(self.v.shape, generator=generator, device=generator.device)
        u, v = self._iterate(w, _l2normalize(u.to(dev)), _l2normalize(v.to(dev)),
                             self.init_power_iterations)
        self.u.copy_(u)
        self.v.copy_(v)

    @torch.no_grad()
    def power_iterate(self):
        u, v = self._iterate(self.w_bar, self.u, self.v, self.power_iterations)
        self.u.copy_(u)
        self.v.copy_(v)

    def forward(self, x):
        if self.training and not replaying():
            self.power_iterate()
        return self._transform(self.weight(), x) + self.b


class SpectralNormDense(_SpectralNorm):
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

    @staticmethod
    def _iterate(w, u, v, n: int):
        for _ in range(n):
            v = _l2normalize(w @ u)
            u = _l2normalize(w.T @ v)
        return u, v

    def init(self, generator):
        bound = math.sqrt(1.0 / self.in_features)
        self._init(generator, uniform(generator, tuple(self.w_bar.shape), bound,
                                      self.b.device), bound)

    def weight(self) -> torch.Tensor:
        """The effective (in, out) weight on the stored u, v."""
        sigma = self.u @ (self.w_bar.T @ self.v)
        return _capped(self.w_bar, sigma, self.coeff, self.eps)

    @staticmethod
    def _transform(w, x):
        return pm.matmul(x, w)


class SpectralNormConv2d(_SpectralNorm):
    """3x3 SAME conv (NHWC in and out, ``w_bar`` HWIO) with a coeff-capped
    spectral norm: of the conv operator on an (H, W) featuremap when
    ``spatial`` is given, else of the matricized kernel."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 3,
                 coeff: float = 0.97, eps: float = 1.0e-5, power_iterations: int = 1,
                 init_power_iterations: int = 10, spatial=None, device=None):
        super().__init__()
        if kernel_size % 2 != 1:
            raise ValueError(f"SAME padding needs an odd kernel_size, got {kernel_size}")
        self.in_channels = in_channels
        self.out_channels = out_channels
        self.kernel_size = kernel_size
        self.coeff = coeff
        self.eps = eps
        self.power_iterations = power_iterations
        self.init_power_iterations = init_power_iterations
        self.spatial = tuple(spatial) if spatial is not None else None
        k = kernel_size
        kw = dict(device=device, dtype=torch.float32)
        self.w_bar = nn.Parameter(torch.zeros(k, k, in_channels, out_channels, **kw))
        self.b = nn.Parameter(torch.zeros(out_channels, **kw))
        if self.spatial is not None:
            u_shape, v_shape = (1, *self.spatial, out_channels), (1, *self.spatial, in_channels)
        else:
            u_shape, v_shape = (out_channels,), (k * k * in_channels,)
        self.register_buffer("u", torch.zeros(u_shape, **kw))
        self.register_buffer("v", torch.zeros(v_shape, **kw))

    def _transform(self, w, x):
        """NHWC x conv HWIO w, SAME padding, no bias."""
        y = pm.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                     padding=self.kernel_size // 2)
        return y.permute(0, 2, 3, 1)

    def _transform_t(self, w, y):
        """The adjoint of ``_transform(w, .)``: the conv's VJP on an NHWC y."""
        x = pm.conv_transpose2d(y.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                               padding=self.kernel_size // 2)
        return x.permute(0, 2, 3, 1)

    def _matrix(self, w):
        return w.reshape(-1, self.out_channels).T          # (out, kh kw in)

    def _iterate(self, w, u, v, n: int):
        for _ in range(n):
            if self.spatial is not None:
                v = _l2normalize(self._transform_t(w, u))
                u = _l2normalize(self._transform(w, v))
            else:
                mat = self._matrix(w)
                v = _l2normalize(mat.T @ u)
                u = _l2normalize(mat @ v)
        return u, v

    def init(self, generator):
        bound = math.sqrt(1.0 / (self.in_channels * self.kernel_size ** 2))
        self._init(generator, uniform(generator, tuple(self.w_bar.shape), bound,
                                      self.b.device), bound)

    def weight(self) -> torch.Tensor:
        """The effective HWIO kernel on the stored u, v."""
        if self.spatial is not None:
            sigma = torch.sum(self.u * self._transform(self.w_bar, self.v))
        else:
            sigma = self.u @ (self._matrix(self.w_bar) @ self.v)
        return _capped(self.w_bar, sigma, self.coeff, self.eps)


class LipSwish(Net):
    def __init__(self, device=None):
        super().__init__()
        self.beta = nn.Parameter(torch.ones(1, device=device, dtype=torch.float32))

    @torch.no_grad()
    def init(self, generator):
        self.beta.fill_(1.0)

    def forward(self, x):
        return x * torch.sigmoid(self.beta * x) / 1.1
