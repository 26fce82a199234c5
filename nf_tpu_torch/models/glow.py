"""Glow model builder (counterpart of ``nf_tpu/models/glow.py``).

* density mode: n x [ActNorm -> InvertibleConv1x1 -> AffineCoupling(alt odd)];
* image mode (NHWC): ``multiscale``'s skeleton with n x [ActNorm ->
  InvertibleConv1x1 -> AffineCoupling] as its block.  At 32x32 and n = 32
  that is 161 couplings.

``cfg.scan`` / ``cfg.remat`` / ``cfg.compute_dtype`` as RealNVP's, the
scan period 6 (two steps of three layers).
"""
from __future__ import annotations

from ..bijectors.conv1x1 import InvertibleConv1x1
from ..bijectors.coupling import AffineCoupling
from ..bijectors.norm import ActNorm
from .base import FlowModel
from .multiscale import multiscale, stage_folder, top_bijector

# two [ActNorm, InvertibleConv1x1, Coupling] steps: nf_tpu's scan period
PERIOD = 6


def build_glow(dims, datatype=None, cfg=None, device=None) -> FlowModel:
    bf = getattr(cfg, "base_filters", 32)
    cd = getattr(cfg, "compute_dtype", None)
    fold = stage_folder(cfg, PERIOD)

    def block(n, dims, masking):
        """n x [ActNorm -> InvertibleConv1x1 -> AffineCoupling], the
        coupling parity alternating."""
        return [l for i in range(n) for l in (
            ActNorm(dims[-1], device=device),
            InvertibleConv1x1(dims[-1], device=device),
            AffineCoupling(dims, masking=masking, odd=i % 2 != 0, base_filters=bf,
                           device=device, compute_dtype=cd))]

    layers = (multiscale(dims, cfg.layers, block, fold) if datatype == "image"
              else fold(block(cfg.layers, dims, "checkerboard")))
    return FlowModel("glow", top_bijector(layers, cfg), dims, device)
