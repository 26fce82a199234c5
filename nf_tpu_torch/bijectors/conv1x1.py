"""Invertible 1x1 convolution with PLU parameterization (Glow); counterpart
of ``nf_tpu/bijectors/conv1x1.py``.

``W = P L U`` with ``P`` a fixed permutation, ``L`` unit lower triangular
(only the strict lower part of the parameter counts), ``U`` strict upper
plus ``diag(sign_s * exp(log_s))``.  Forward ``y = x @ W.T`` per channel
vector, logdet ``sum(log_s) * n_pixels``; the inverse is
``x = y @ (U^-1 L^-1 P^T).T``, the two triangular inverses formed by
solves against the C x C identity.  ``nf_tpu`` solves against all N
pixel vectors instead; on an H100 ``torch.linalg.solve_triangular``
takes 15.9 s for glow-img32x3's (3, 1,048,576) right-hand side, where
this takes 0.35 ms (``conv1x1_inverse_probe.py``).  ``P``
and ``sign_s`` are buffers, as ``nf_tpu`` keeps them in state.
"""
from __future__ import annotations

import torch
from torch import nn

from ..core.bijector import Bijector
from ..ops import precision as pm
from .norm import _num_pixels


def random_orthogonal(generator: torch.Generator, n: int, device) -> torch.Tensor:
    """An orthogonal (n, n) matrix from ``generator``: Q of the QR of a
    standard-normal matrix, column signs fixed by diag(R)."""
    a = torch.randn(n, n, generator=generator, device=generator.device,
                    dtype=torch.float32)
    q, r = torch.linalg.qr(a)
    return (q * torch.sign(torch.diagonal(r))[None, :]).to(device)


class InvertibleConv1x1(Bijector):
    def __init__(self, num_channels: int, device=None):
        super().__init__()
        self.num_channels = num_channels
        c = num_channels
        kw = dict(device=device, dtype=torch.float32)
        self.L = nn.Parameter(torch.eye(c, **kw))
        self.U = nn.Parameter(torch.zeros(c, c, **kw))
        self.log_s = nn.Parameter(torch.zeros(c, **kw))
        self.register_buffer("P", torch.eye(c, **kw))
        self.register_buffer("sign_s", torch.ones(c, **kw))

    @torch.no_grad()
    def init(self, generator):
        w = random_orthogonal(generator, self.num_channels, self.L.device)
        # A = P L U, the convention of scipy.linalg.lu
        p, l, u = torch.linalg.lu(w)
        s = torch.diagonal(u)
        self.L.copy_(l)
        self.U.copy_(torch.triu(u, diagonal=1))
        self.log_s.copy_(torch.log(torch.abs(s)))
        self.P.copy_(p)
        self.sign_s.copy_(torch.sign(s))

    def factors(self):
        """(P, L, U) with the structure imposed: unit lower L, upper U."""
        eye = torch.eye(self.num_channels, dtype=torch.float32, device=self.L.device)
        L = torch.tril(self.L, diagonal=-1) + eye
        U = torch.triu(self.U, diagonal=1) + torch.diag(self.sign_s * torch.exp(self.log_s))
        return self.P, L, U

    def weight(self) -> torch.Tensor:
        P, L, U = self.factors()
        return P @ L @ U

    def _logdet(self, x, sign):
        return (sign * self.log_s.sum() * _num_pixels(x)).expand(x.shape[0])

    def forward(self, x):
        return pm.matmul(x, self.weight().T), self._logdet(x, 1.0)

    def inverse(self, y):
        P, L, U = self.factors()
        eye = torch.eye(self.num_channels, dtype=L.dtype, device=L.device)
        l_inv = torch.linalg.solve_triangular(L, eye, upper=False, unitriangular=True)
        u_inv = torch.linalg.solve_triangular(U, eye, upper=True)
        return pm.matmul(y, (u_inv @ l_inv @ P.T).T), self._logdet(y, -1.0)
