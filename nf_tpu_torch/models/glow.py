"""Glow model builder (counterpart of ``nf_tpu/models/glow.py``), density
mode: n x [ActNorm -> InvertibleConv1x1 -> AffineCoupling(alt odd)]."""
from __future__ import annotations

from ..bijectors.conv1x1 import InvertibleConv1x1
from ..bijectors.coupling import AffineCoupling
from ..bijectors.norm import ActNorm
from ..core.bijector import Chain
from .base import FlowModel


def build_glow(dims, datatype=None, cfg=None, device=None) -> FlowModel:
    if datatype == "image":
        raise NotImplementedError("the Glow image tier lands in a later slice")
    bf = getattr(cfg, "base_filters", 32)
    layers = [l for i in range(cfg.layers) for l in (
        ActNorm(dims[-1], device=device),
        InvertibleConv1x1(dims[-1], device=device),
        AffineCoupling(dims, odd=i % 2 != 0, base_filters=bf, device=device))]
    return FlowModel("glow", Chain(layers), dims, device)
