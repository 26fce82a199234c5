"""Planar transform z' = z + u tanh(w.z + b) (counterpart of
``nf_tpu/bijectors/planar.py``).

* u is replaced by u_hat = u + (softplus(w.u) - 1 - w.u) w / ||w||^2 only
  where w.u < -1, a reparameterization inside each call that keeps the
  map invertible;
* log-det log|1 + (w.u) tanh'(w.z + b)| + 1e-5;
* inverse: the map moves z only along u, and w.z' = a + (w.u) tanh(a + b)
  is monotone in a = w.z, so a is found by ``bisect_monotone`` (64 trips)
  and z = z' - u tanh(a + b).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..core.bijector import Bijector
from ..ops import precision as pm
from ..ops.bisect import bisect_monotone
from ..ops.math import deriv_tanh


class PlanarTransform(Bijector):
    def __init__(self, dim: int, device=None):
        super().__init__()
        self.dim = dim
        kw = dict(device=device, dtype=torch.float32)
        self.u = nn.Parameter(torch.zeros(dim, **kw))
        self.w = nn.Parameter(torch.zeros(dim, **kw))
        self.b = nn.Parameter(torch.zeros(1, **kw))

    @torch.no_grad()
    def init(self, generator):
        for p in (self.u, self.w, self.b):
            z = torch.randn(p.shape, generator=generator, device=generator.device)
            p.copy_(z.to(p.device) * 0.01)

    def _constrained(self):
        u, w = self.u, self.w
        wu = torch.dot(w, u)
        u_hat = u + (-1.0 + F.softplus(wu) - wu) * w / (torch.dot(w, w) + 1e-12)
        u = torch.where(wu < -1.0, u_hat, u)
        return u, torch.dot(w, u)

    @staticmethod
    def _logdet(affine, wu):
        return torch.log(torch.abs(1.0 + wu * deriv_tanh(affine)) + 1.0e-5)

    def forward(self, z):
        u, wu = self._constrained()
        affine = pm.matmul(z, self.w) + self.b
        return z + u[None, :] * torch.tanh(affine)[:, None], self._logdet(affine, wu)

    def inverse(self, y):
        u, wu = self._constrained()
        b = self.b[0]
        wy = pm.matmul(y, self.w)
        a = bisect_monotone(lambda a: a + wu * torch.tanh(a + b), wy,
                            torch.full_like(wy, -1.0e3), torch.full_like(wy, 1.0e3))
        affine = a + b
        return y - u[None, :] * torch.tanh(affine)[:, None], -self._logdet(affine, wu)
