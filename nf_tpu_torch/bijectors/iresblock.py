"""Invertible residual blocks (counterpart of
``nf_tpu/bijectors/iresblock.py``), eval mode.

* forward: f(x) = x + g(x), with the configured estimator's log-det
  ('exact' | 'fixed' | 'unbias', the reference's eval sample counts: 4
  probes, 8 terms for 'fixed', n_exact = 8 for 'unbias');
* inverse: the fixed point x <- z - g(x) from x0 = z - g(z), while
  ``it < n_iters`` and the BATCH-WIDE max|x - prev| >= ftol, ``it``
  starting at 1 with x0 tested against z itself; then the log-det at the
  solved x, negated.

``probes`` (``ops/estimators.py``'s (V, n_terms)) can be handed to
``forward`` / ``inverse`` (a ``Chain``'s forward hands its own to every
block); without them the block draws the serving set (``eval_probes``: a
generator seeded 0 on the data's device), the counterpart of ``nf_tpu``'s
``PRNGKey(0)`` when ``ctx.rng`` is None.  Training (``iresblock_forward``'s memory-saved gradient) lands
with the training slice.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..core.bijector import Bijector
from ..nets.core import Sequential
from ..nets.layers import _TRAINING
from ..nets.spectral import LipSwish, SpectralNormDense
from ..ops import estimators as est


class InvertibleResBlock(Bijector):
    takes_probes = True

    def __init__(self, g_net, estimator: str = "unbias", ftol: float = 1.0e-4,
                 n_iters: int = 100):
        super().__init__()
        if estimator not in ("exact", "fixed", "unbias"):
            raise ValueError(f"unknown log-det estimator {estimator!r}")
        self.g_net = g_net
        self.estimator = estimator
        self.ftol = ftol
        self.n_iters = n_iters

    def _logdet(self, x, probes: Optional[est.Probes]):
        if self.training:
            raise NotImplementedError(_TRAINING)
        if self.estimator == "exact":
            return est.logdet_exact(self.g_net, x)
        if probes is None:
            probes = est.eval_probes(self.estimator, x.shape[0], x[0].numel(), x.device)
        v, n_terms = probes
        if self.estimator == "fixed":
            return est.logdet_fixed(self.g_net, x, v, n_power_series=est.N_POWER_SERIES)
        return est.logdet_unbias(self.g_net, x, v, n_terms, p=est.P, n_exact=est.N_EXACT)

    def forward(self, x, probes: Optional[est.Probes] = None):
        return x + self.g_net(x), self._logdet(x, probes)

    @torch.no_grad()
    def solve(self, z):
        """The fixed point of x = z - g(x): returns (x, it), ``it`` the
        trip count of ``nf_tpu``'s while loop."""
        x, prev, it = z - self.g_net(z), z, 1
        while it < self.n_iters and float(torch.max(torch.abs(x - prev))) >= self.ftol:
            x, prev, it = z - self.g_net(x), x, it + 1
        return x, it

    def inverse(self, z, probes: Optional[est.Probes] = None):
        x, _ = self.solve(z)
        return x, -self._logdet(x, probes)


def InvertibleResLinear(in_features: int, out_features: int, base_filters: int = 32,
                        n_layers: int = 2, coeff: float = 0.97, ftol: float = 1.0e-4,
                        logdet_estimator: str = "unbias", device=None) -> InvertibleResBlock:
    """Dense g: SN-Dense / LipSwish stack."""
    dims = [in_features] + [base_filters] * n_layers + [out_features]
    layers = []
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        layers.append(SpectralNormDense(din, dout, coeff=coeff, device=device))
        if i != len(dims) - 2:
            layers.append(LipSwish(device=device))
    return InvertibleResBlock(Sequential(layers), estimator=logdet_estimator, ftol=ftol)
