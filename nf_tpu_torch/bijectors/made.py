"""MADE masked autoregressive networks and the MAF transform step
(counterpart of ``nf_tpu/bijectors/made.py``).

* ``MADE``: a masked dense stack, each hidden layer followed by a
  ``BatchNormNet`` and ReLU, with the optional companion term (a dense map
  of a ones vector through the same mask, ``use_companion``).  Its masks
  are buffers drawn once at ``init``: a seed taken from the generator
  feeds numpy's ``made_degrees``, as ``nf_tpu`` seeds numpy from its key.
  With ``resample_masks`` a forward that is handed a generator (the
  trainer's, per step) draws new masks from it (``sample_masks``), never
  from the global RNG; the same distribution, drawn on the device.
* ``AutoregressiveTransform``: a fixed permutation buffer, two MADEs for
  s and t, s = tanh(raw) * s_log_scale + s_bias; the forward is one pass,
  the inverse D sequential passes, each solving one column, with the
  conditioners on their running statistics (eval), as ``nf_tpu`` solves.

Layout: weights and masks are PyTorch's ``(out, in)``, where ``nf_tpu``
keeps ``(in, out)``; ``convert`` transposes both.
"""
from __future__ import annotations

import math
from contextlib import contextmanager
from typing import List, Optional

import numpy as np
import torch
from torch import nn

from ..core.bijector import Bijector
from ..nets.core import Net
from ..nets.layers import BatchNormNet
from ..ops import precision as pm


def made_degrees(d: int, hidden_dims, rng: np.random.Generator):
    """Sample MADE unit degrees; returns per-layer degree vectors."""
    m_prev = np.arange(d)
    degrees = [m_prev]
    for h in hidden_dims:
        min_k = min(int(m_prev.min()), d - 2)
        m = rng.integers(min_k, max(d - 1, min_k + 1), size=h)
        degrees.append(m)
        m_prev = m
    return degrees


def degrees_to_masks(degrees, d: int):
    """Hidden masks: M[j, k] = 1 iff m_prev[j] <= m[k] (for (in,out) layout);
    output mask: M[k, i] = 1 iff m_last[k] < i."""
    masks = []
    for m_prev, m in zip(degrees[:-1], degrees[1:]):
        masks.append((m_prev[:, None] <= m[None, :]).astype(np.float32))
    m_last = degrees[-1]
    out = (m_last[:, None] < np.arange(d)[None, :]).astype(np.float32)
    masks.append(out)
    return masks


def _normal(generator, shape, scale, device):
    z = torch.randn(shape, generator=generator, device=generator.device, dtype=torch.float32)
    return (z * scale).to(device)


class MADE(Net):
    def __init__(self, in_out_features: int, num_hidden: int = 2,
                 base_filters: int = 32, use_companion: bool = False,
                 resample_masks: bool = False, device=None):
        super().__init__()
        self.d = in_out_features
        self.num_hidden = num_hidden
        self.use_companion = use_companion
        self.resample_masks = resample_masks
        self.hidden_dims = [base_filters] * num_hidden
        dims = [self.d] + self.hidden_dims + [self.d]
        kw = dict(device=device, dtype=torch.float32)
        shapes = list(zip(dims[1:], dims[:-1]))           # (out, in)
        self.w = nn.ParameterList([torch.zeros(s, **kw) for s in shapes])
        self.b = nn.ParameterList([torch.zeros(s[0], **kw) for s in shapes])
        self.u = (nn.ParameterList([torch.zeros(s, **kw) for s in shapes])
                  if use_companion else None)
        self.bn = nn.ModuleList([BatchNormNet(h, device=device) for h in self.hidden_dims])
        for i, s in enumerate(shapes):
            self.register_buffer(f"mask{i}", torch.ones(s, **kw))

    def masks(self) -> List[torch.Tensor]:
        """The masks drawn at init, (out, in) each."""
        return [getattr(self, f"mask{i}") for i in range(len(self.w))]

    @torch.no_grad()
    def init(self, generator):
        seed = int(torch.randint(0, 2 ** 31 - 1, (1,), generator=generator,
                                 device=generator.device))
        degrees = made_degrees(self.d, self.hidden_dims, np.random.default_rng(seed))
        for m, mask in zip(self.masks(), degrees_to_masks(degrees, self.d)):
            m.copy_(torch.from_numpy(mask.T))
        dev = self.b[0].device
        for i, w in enumerate(self.w):
            scale = math.sqrt(2.0 / (w.shape[0] + w.shape[1]))
            w.copy_(_normal(generator, w.shape, scale, dev))
            if self.u is not None:
                self.u[i].copy_(_normal(generator, w.shape, scale, dev))
            self.b[i].copy_(_normal(generator, self.b[i].shape, 0.01, dev))
        for bn in self.bn:
            bn.init(generator)

    def sample_masks(self, generator: torch.Generator) -> List[torch.Tensor]:
        """New masks drawn from ``generator`` on its device, with no read
        back to the host: each hidden degree uniform over [min_k,
        max(d - 1, min_k + 1)), min_k = min(min of the previous degrees,
        d - 2), as ``made_degrees``."""
        d = self.d
        dev = self.mask0.device
        gdev = generator.device
        m_prev = torch.arange(d, device=gdev)
        masks = []
        for h in self.hidden_dims:
            lo = torch.clamp(m_prev.min(), max=d - 2)
            hi = torch.clamp(lo + 1, min=d - 1)
            u = torch.rand(h, generator=generator, device=gdev)
            m = lo + torch.minimum((u * (hi - lo)).long(), hi - lo - 1)
            masks.append((m[:, None] >= m_prev[None, :]).float().to(dev))
            m_prev = m
        out = torch.arange(d, device=gdev)[:, None] > m_prev[None, :]
        masks.append(out.float().to(dev))
        return masks

    def _dense(self, i, x, mask):
        h = pm.linear(x, self.w[i] * mask, self.b[i])
        if self.u is not None:
            h = h + pm.linear(torch.ones_like(x), self.u[i] * mask)
        return h

    def forward(self, z, generator: Optional[torch.Generator] = None):
        masks = (self.sample_masks(generator)
                 if self.resample_masks and generator is not None else self.masks())
        x = z
        for i in range(self.num_hidden):
            x = torch.relu(self.bn[i](self._dense(i, x, masks[i])))
        return self._dense(self.num_hidden, x, masks[-1])


@contextmanager
def _running_statistics(*nets):
    """The nets in eval mode (batch norms on their running statistics)
    for the block, their modes restored after."""
    modes = [n.training for n in nets]
    for n in nets:
        n.eval()
    try:
        yield
    finally:
        for n, mode in zip(nets, modes):
            n.train(mode)


class AutoregressiveTransform(Bijector):
    """One MAF step: permute, then elementwise affine with autoregressive
    conditioners."""

    takes_generator = True

    def __init__(self, in_out_features: int, num_hidden: int = 3,
                 base_filters: int = 32, resample_masks: bool = False, device=None):
        super().__init__()
        self.d = in_out_features
        self.net_s = MADE(in_out_features, num_hidden, base_filters,
                          resample_masks=resample_masks, device=device)
        self.net_t = MADE(in_out_features, num_hidden, base_filters,
                          resample_masks=resample_masks, device=device)
        kw = dict(device=device, dtype=torch.float32)
        self.s_log_scale = nn.Parameter(torch.zeros(1, **kw))
        self.s_bias = nn.Parameter(torch.zeros(1, **kw))
        self.register_buffer("perm", torch.arange(in_out_features, device=device))

    @torch.no_grad()
    def init(self, generator):
        dev = self.perm.device
        self.perm.copy_(torch.randperm(self.d, generator=generator,
                                       device=generator.device).to(dev))
        self.net_s.init(generator)
        self.net_t.init(generator)
        for p in (self.s_log_scale, self.s_bias):
            p.copy_(_normal(generator, (1,), 0.01, dev))

    def _st(self, z, generator=None):
        raw_s = self.net_s(z, generator)
        t = self.net_t(z, generator)
        return torch.tanh(raw_s) * self.s_log_scale + self.s_bias, t

    def forward(self, z, generator: Optional[torch.Generator] = None):
        z = z[:, self.perm]
        s, t = self._st(z, generator)
        return z * torch.exp(s) + t, s.sum(dim=1)

    def inverse(self, y):
        z = y
        ld = torch.zeros(y.shape[0], dtype=torch.float32, device=y.device)
        cols = torch.arange(self.d, device=y.device)
        with _running_statistics(self.net_s, self.net_t):
            for i in range(self.d):
                s, t = self._st(z)
                z = z.index_copy(1, cols[i:i + 1], ((y - t) * torch.exp(-s))[:, i:i + 1])
                ld = ld - s[:, i]
        return z[:, torch.argsort(self.perm)], ld
