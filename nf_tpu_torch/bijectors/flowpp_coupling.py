"""Flow++ logistic-mixture attention coupling (counterpart of
``nf_tpu/bijectors/flowpp_coupling.py``).

Conditioner: in-proj -> GatedLinear -> LayerNorm -> GatedAttn -> LayerNorm
-> out-proj emitting ``(a, b, logpi, mu, s)`` along the last axis: dense
layers for 1-D data; for NHWC images 3x3 convs (no weight norm) and
``GatedConv2d`` over the half's spatial shape (h/2, w/2 for the
checkerboard split, h, w channelwise), attention over its pixels.  The
transform is ``z0 -> logit(MixLogCDF(z0)) * exp(a) + b`` with ``a =
tanh(raw_a) * a_log_scale + a_bias``; the inverse undoes the affine and
solves the mixture by Newton.  Mixture tensors reshape k-major, ``(...,
K * oc) -> (..., K, oc) -> (..., oc, K)``, as the reference's
``view(B, K, *C)``; for images the same on each pixel's channels.
"""
from __future__ import annotations

import torch
from torch import nn

from ..nets.core import Sequential
from ..nets.gated import GatedAttn, GatedConv2d, GatedLinear, LayerNormNet
from ..nets.layers import Conv2d, Dense
from ..ops.math import sum_except_batch
from .coupling import _CouplingBase
from .mixlogcdf import mix_log_cdf_logit_forward, mix_log_cdf_logit_inverse


class MixLogAttnCoupling(_CouplingBase):
    def __init__(self, dims, masking="checkerboard", odd=False,
                 base_filters: int = 32, n_mixtures: int = 4, device=None):
        super().__init__(dims, masking, odd)
        self.n_mixtures = n_mixtures
        self.out_chs, in_chs = self.half_dims()
        n_out = self.out_chs * (2 + 3 * n_mixtures)
        bf = base_filters
        if len(self.dims) == 1:
            mid = (bf,)
            proj_in = Dense(in_chs, bf, weight_norm=False, device=device)
            gated = GatedLinear(bf, device=device)
            proj_out = Dense(bf, n_out, weight_norm=False, device=device)
        else:
            h, w, _ = self.dims
            mid = (h // 2, w // 2, bf) if masking == "checkerboard" else (h, w, bf)
            proj_in = Conv2d(in_chs, bf, 3, weight_norm=False, device=device)
            gated = GatedConv2d(bf, device=device)
            proj_out = Conv2d(bf, n_out, 3, weight_norm=False, device=device)
        self.net = Sequential([
            proj_in,
            gated,
            LayerNormNet(mid, device=device),
            GatedAttn(mid, bf, device=device),
            LayerNormNet(mid, device=device),
            proj_out,
        ])
        kw = dict(device=device, dtype=torch.float32)
        self.a_log_scale = nn.Parameter(torch.zeros(1, **kw))
        self.a_bias = nn.Parameter(torch.zeros(1, **kw))

    @torch.no_grad()
    def init(self, generator):
        self.net.init(generator)
        for p in (self.a_log_scale, self.a_bias):
            z = torch.randn(1, generator=generator, device=generator.device)
            p.copy_(z * 0.01)

    def _cond_params(self, z1):
        raw = self.net(z1)
        oc, K = self.out_chs, self.n_mixtures

        def mix(t):   # (..., K * oc) -> (..., oc, K), k-major
            return t.reshape(t.shape[:-1] + (K, oc)).transpose(-1, -2)

        a = torch.tanh(raw[..., :oc]) * self.a_log_scale + self.a_bias
        b = raw[..., oc:2 * oc]
        logpi = torch.log_softmax(mix(raw[..., 2 * oc:2 * oc + oc * K]), dim=-1)
        mu = mix(raw[..., 2 * oc + oc * K:2 * oc + 2 * oc * K])
        s = mix(raw[..., 2 * oc + 2 * oc * K:])
        return a, b, logpi, mu, s

    def _transform(self, z0, z1):
        a, b, logpi, mu, s = self._cond_params(z1)
        z0, ld = mix_log_cdf_logit_forward(z0, logpi, mu, s)
        return z0 * torch.exp(a) + b, ld + sum_except_batch(a)

    def _inverse_transform(self, y0, y1):
        a, b, logpi, mu, s = self._cond_params(y1)
        y0 = (y0 - b) * torch.exp(-a)
        x0, ld = mix_log_cdf_logit_inverse(y0, logpi, mu, s)
        return x0, ld - sum_except_batch(a)
