"""Flow++ model builder (counterpart of ``nf_tpu/models/flowpp.py``),
density mode: n x [ActNorm -> MixLogAttnCoupling(alt odd)]."""
from __future__ import annotations

from ..bijectors.flowpp_coupling import MixLogAttnCoupling
from ..bijectors.norm import ActNorm
from ..core.bijector import Chain
from .base import FlowModel


def build_flowpp(dims, datatype=None, cfg=None, device=None) -> FlowModel:
    if datatype == "image":
        raise NotImplementedError("the Flow++ image tier (and its variational "
                                  "dequantization) lands in a later slice")
    bf = getattr(cfg, "base_filters", 32)
    layers = [l for i in range(cfg.layers) for l in (
        ActNorm(dims[-1], device=device),
        MixLogAttnCoupling(dims, odd=i % 2 != 0, base_filters=bf,
                           n_mixtures=cfg.mixtures, device=device))]
    return FlowModel("flow++", Chain(layers), dims, device)
