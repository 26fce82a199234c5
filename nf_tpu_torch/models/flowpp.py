"""Flow++ model builder (counterpart of ``nf_tpu/models/flowpp.py``).

* density mode: n x [ActNorm -> MixLogAttnCoupling(alt odd)];
* image mode (NHWC): Logit(0.01, compress=True), then while the spatial
  size is above 8: n x [ActNorm -> InvertibleConv1x1 -> checkerboard
  MixLogAttnCoupling] -> Squeeze2d -> the same n times channelwise; a
  final checkerboard block of n + 1; Unsqueeze2d back to the input's
  resolution.  At 32x32x1 and n = 32 that is 161 couplings.

``nf_tpu``'s ``var_dequant`` (variational dequantization, a training
objective: its eval context has no random key to draw the noise from),
``scan`` and ``remat`` are not ported and raise.
"""
from __future__ import annotations

from ..bijectors.conv1x1 import InvertibleConv1x1
from ..bijectors.elementwise import Logit
from ..bijectors.flowpp_coupling import MixLogAttnCoupling
from ..bijectors.norm import ActNorm
from ..bijectors.squeeze import Squeeze2d, Unsqueeze2d
from ..core.bijector import Chain
from .base import FlowModel


def _image_block(n, dims, masking, bf, K, device):
    """n x [ActNorm -> InvertibleConv1x1 -> MixLogAttnCoupling], the
    coupling parity alternating."""
    return [l for i in range(n) for l in (
        ActNorm(dims[-1], device=device),
        InvertibleConv1x1(dims[-1], device=device),
        MixLogAttnCoupling(dims, masking=masking, odd=i % 2 != 0, base_filters=bf,
                           n_mixtures=K, device=device))]


def build_flowpp(dims, datatype=None, cfg=None, device=None) -> FlowModel:
    for flag in ("scan", "remat"):
        if getattr(cfg, flag, False):
            raise NotImplementedError(f"Flow++ with {flag}=True is not ported yet")
    n, K = cfg.layers, cfg.mixtures
    bf = getattr(cfg, "base_filters", 32)
    if datatype != "image":
        layers = [l for i in range(n) for l in (
            ActNorm(dims[-1], device=device),
            MixLogAttnCoupling(dims, odd=i % 2 != 0, base_filters=bf, n_mixtures=K,
                               device=device))]
        return FlowModel("flow++", Chain(layers), dims, device)
    if getattr(cfg, "var_dequant", False):
        raise NotImplementedError("Flow++ variational dequantization lands with the Flow++ "
                                  "training slice")
    h, w, c = dims
    layers = [Logit(eps=0.01, compress=True)]
    mid = (h, w, c)
    while max(mid[0], mid[1]) > 8:
        layers += _image_block(n, mid, "checkerboard", bf, K, device)
        layers.append(Squeeze2d(odd=False))
        mid = (mid[0] // 2, mid[1] // 2, mid[2] * 4)
        layers += _image_block(n, mid, "channelwise", bf, K, device)
    layers += _image_block(n + 1, mid, "checkerboard", bf, K, device)
    while mid[0] != h or mid[1] != w:
        layers.append(Unsqueeze2d(odd=False))
        mid = (mid[0] * 2, mid[1] * 2, mid[2] // 4)
    return FlowModel("flow++", Chain(layers), dims, device)
