"""Invertible residual blocks (counterpart of
``nf_tpu/bijectors/iresblock.py``).

* forward in eval mode: f(x) = x + g(x), with the configured estimator's
  log-det ('exact' | 'fixed' | 'unbias', the reference's eval sample
  counts: 4 probes, 8 terms for 'fixed', n_exact = 8 for 'unbias');
* forward in train mode, whatever the estimator (``nf_tpu`` forces the
  roulette): one stateful pass of g, which runs each spectral norm's power
  iteration and is discarded, then ``iresblock_forward``'s memory-saved
  Function over g in eval mode on the updated u, v (``nf_tpu``'s
  ``_g_apply_pure``), so the vectors move once per step;
* inverse: the fixed point x <- z - g(x) from x0 = z - g(z), while
  ``it < n_iters`` and the BATCH-WIDE max|x - prev| >= ftol, ``it``
  starting at 1 with x0 tested against z itself; then the log-det at the
  solved x, negated.

``probes`` (``ops/estimators.py``'s (V, n_terms)) can be handed to the eval
forward / inverse (a ``Chain``'s forward hands its own to every block);
without them the block draws the serving set (``eval_probes``: a generator
seeded 0 on the data's device), the counterpart of ``nf_tpu``'s
``PRNGKey(0)`` when ``ctx.rng`` is None.  Training draws its two series'
lengths and probes (``draw_train_probes``) from the step's ``generator``
(one seeded 0 without it); ``injected_train_probes`` replaces the draw
(tests hand it ``nf_tpu``'s).
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Optional

import torch

from ..core.bijector import Bijector, replaying
from ..nets.core import Sequential
from ..nets.spectral import LipSwish, SpectralNormConv2d, SpectralNormDense
from ..ops import estimators as est


@contextmanager
def _eval_mode(net):
    mode = net.training
    net.train(False)
    try:
        yield
    finally:
        net.train(mode)


class InvertibleResBlock(Bijector):
    takes_probes = True
    takes_generator = True

    def __init__(self, g_net, estimator: str = "unbias", ftol: float = 1.0e-4,
                 n_iters: int = 100):
        super().__init__()
        if estimator not in ("exact", "fixed", "unbias"):
            raise ValueError(f"unknown log-det estimator {estimator!r}")
        self.g_net = g_net
        self.estimator = estimator
        self.ftol = ftol
        self.n_iters = n_iters
        # ((n_val, v_val), (n_grad, v_grad)) used instead of a training draw
        self.injected_train_probes: Optional[est.TrainProbes] = None

    def _g_eval(self, x):
        """g on the stored spectral-norm vectors, whatever the mode."""
        with _eval_mode(self.g_net):
            return self.g_net(x)

    def _logdet(self, x, probes: Optional[est.Probes]):
        if self.estimator == "exact":
            return est.logdet_exact(self._g_eval, x)
        if probes is None:
            probes = est.eval_probes(self.estimator, x.shape[0], x[0].numel(), x.device)
        v, n_terms = probes
        if self.estimator == "fixed":
            return est.logdet_fixed(self._g_eval, x, v, n_power_series=est.N_POWER_SERIES)
        return est.logdet_unbias(self._g_eval, x, v, n_terms, p=est.P, n_exact=est.N_EXACT)

    def _train_forward(self, x, generator: Optional[torch.Generator]):
        if not replaying():         # a recompute finds u, v already moved
            with torch.no_grad():
                self.g_net(x)
        draws = self.injected_train_probes
        if draws is None:
            if generator is None:
                generator = torch.Generator(device=x.device).manual_seed(0)
            draws = est.draw_train_probes(x.shape, generator)
        g, logdet = est.iresblock_forward(self._g_eval, list(self.g_net.parameters()), x,
                                          draws)
        return x + g, logdet

    def forward(self, x, probes: Optional[est.Probes] = None,
                generator: Optional[torch.Generator] = None):
        if self.training:
            return self._train_forward(x, generator)
        return x + self.g_net(x), self._logdet(x, probes)

    @torch.no_grad()
    def solve(self, z):
        """The fixed point of x = z - g(x): returns (x, it), ``it`` the
        trip count of ``nf_tpu``'s while loop."""
        g = self._g_eval
        x, prev, it = z - g(z), z, 1
        while it < self.n_iters and float(torch.max(torch.abs(x - prev))) >= self.ftol:
            x, prev, it = z - g(x), x, it + 1
        return x, it

    def inverse(self, z, probes: Optional[est.Probes] = None):
        x, _ = self.solve(z)
        return x, -self._logdet(x, probes)


def _g_stack(layer, dims, coeff: float, device):
    layers = []
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        layers.append(layer(din, dout, coeff=coeff, device=device))
        if i != len(dims) - 2:
            layers.append(LipSwish(device=device))
    return Sequential(layers)


def InvertibleResLinear(in_features: int, out_features: int, base_filters: int = 32,
                        n_layers: int = 2, coeff: float = 0.97, ftol: float = 1.0e-4,
                        logdet_estimator: str = "unbias", device=None) -> InvertibleResBlock:
    """Dense g: SN-Dense / LipSwish stack."""
    dims = [in_features] + [base_filters] * n_layers + [out_features]
    return InvertibleResBlock(_g_stack(SpectralNormDense, dims, coeff, device),
                              estimator=logdet_estimator, ftol=ftol)


def InvertibleResConv2d(in_channels: int, out_channels: int, base_filters: int = 32,
                        n_layers: int = 2, coeff: float = 0.97, ftol: float = 1.0e-4,
                        logdet_estimator: str = "unbias", spatial=None,
                        device=None) -> InvertibleResBlock:
    """Conv g over NHWC: SN-Conv2d / LipSwish stack; ``spatial = (H, W)``
    gives each spectral norm the conv operator's norm on that featuremap."""
    dims = [in_channels] + [base_filters] * n_layers + [out_channels]

    def conv(din, dout, coeff, device):
        return SpectralNormConv2d(din, dout, coeff=coeff, spatial=spatial, device=device)

    return InvertibleResBlock(_g_stack(conv, dims, coeff, device),
                              estimator=logdet_estimator, ftol=ftol)
