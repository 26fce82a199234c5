"""Variational dequantization head (Flow++), counterpart of
``nf_tpu/bijectors/vardequant.py``.

``forward`` takes the raw image x in [0, 1], quantizes it to 256 bins,
draws u from a conditional flow q(u | x) and returns y = (x_q + u) / 256
with log-det ``-log q(u | x) - D log 256``, so the model's log p over the
chain is the single-sample ELBO.  q(u | x): eps ~ N(0, I) -> an affine
(mu(x), tanh-bounded log sigma(x)) -> two x-conditioned checkerboard affine
couplings with tanh-bounded scales -> sigmoid.  ``inverse`` passes y
through with log-det 0 (samples are continuous images).

The noise comes from the generator handed to ``forward`` (the training
step's, ``Trainer.log_prob``'s or the data-dependent init's); without one
it raises, as ``nf_tpu`` raises on ``ctx.rng is None``, so an eval program
never reuses one fixed sample.  ``_flow`` takes eps as an argument, and
``injected_eps`` replaces the draw of a forward (still only with a
generator), so tests inject ``nf_tpu``'s draw.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..core.bijector import Bijector
from ..nets.conditioners import ConvNet
from ..ops.math import log_deriv_sigmoid, standard_normal_logprob, sum_except_batch
from ..parallel.distributed import draw_rows


def checker_mask(h: int, w: int, c: int, odd: bool, device=None) -> torch.Tensor:
    """(h, w, c): (i + j) % 2 over the pixels, flipped unless ``odd``."""
    i = torch.arange(h, device=device)[:, None]
    j = torch.arange(w, device=device)[None, :]
    m = ((i + j) % 2).to(torch.float32)
    if not odd:
        m = 1.0 - m
    return m[..., None].expand(h, w, c).contiguous()


class VariationalDequant(Bijector):
    takes_generator = True

    def __init__(self, dims, base_filters: int = 32, n_bins: int = 256, device=None):
        super().__init__()
        self.dims = tuple(dims)
        h, w, c = self.dims
        self.n_bins = n_bins
        self.net_affine = ConvNet(c, 2 * c, base_filters, device=device)
        for i, odd in enumerate((False, True)):
            self.register_buffer(f"mask{i}", checker_mask(h, w, c, odd, device),
                                 persistent=False)
        self.net_couplings = nn.ModuleList([ConvNet(2 * c, 2 * c, base_filters, device=device)
                                            for _ in range(2)])
        # x.shape, used instead of a draw when set
        self.injected_eps: Optional[torch.Tensor] = None

    def _flow(self, x, eps):
        """eps -> (u, log q(u | x)); every net conditions on the raw x."""
        c = x.shape[-1]
        logq = standard_normal_logprob(eps)
        out = self.net_affine(x)
        mu, log_sigma = out[..., :c], torch.tanh(out[..., c:])
        z = mu + torch.exp(log_sigma) * eps
        logq = logq - sum_except_batch(log_sigma)
        for mask, net in zip((self.mask0, self.mask1), self.net_couplings):
            out = net(torch.cat([x, z * mask], dim=-1))
            s = torch.tanh(out[..., :c]) * (1.0 - mask)
            t = out[..., c:] * (1.0 - mask)
            z = z * torch.exp(s) + t
            logq = logq - sum_except_batch(s)
        u = torch.sigmoid(z)
        logq = logq - sum_except_batch(log_deriv_sigmoid(z))
        return u, logq

    def forward(self, x, generator: Optional[torch.Generator] = None):
        if generator is None:
            raise ValueError("VariationalDequant.forward requires a generator (fresh "
                             "dequantization noise per call); got None")
        nb = float(self.n_bins)
        xq = torch.floor(torch.clamp(x, 0.0, 1.0 - 1e-6) * nb)
        eps = self.injected_eps
        if eps is None:   # this rank's rows of the host's draw in a data-parallel step
            eps = draw_rows(x.shape, generator)
        eps = eps.to(device=x.device, dtype=x.dtype)
        u, logq = self._flow(x, eps)
        d = math.prod(self.dims)
        return (xq + u) / nb, -logq - d * math.log(nb)

    def inverse(self, y):
        return y, torch.zeros(y.shape[0], dtype=torch.float32, device=y.device)
