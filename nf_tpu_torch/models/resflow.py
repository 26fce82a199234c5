"""Residual Flow model builder (counterpart of ``nf_tpu/models/resflow.py``),
density mode: n x [ActNorm -> InvertibleResLinear(coeff=cfg.spnorm_coeff,
estimator=cfg.logdet)]."""
from __future__ import annotations

from ..bijectors.iresblock import InvertibleResLinear
from ..bijectors.norm import ActNorm
from ..core.bijector import Chain
from .base import FlowModel


def build_resflow(dims, datatype=None, cfg=None, device=None) -> FlowModel:
    if datatype == "image":
        raise NotImplementedError("the ResFlow conv variant (image data) lands in a "
                                  "later slice")
    D = dims[-1]
    layers = [l for _ in range(cfg.layers) for l in (
        ActNorm(D, device=device),
        InvertibleResLinear(D, D, base_filters=cfg.base_filters, coeff=cfg.spnorm_coeff,
                            logdet_estimator=cfg.logdet, device=device))]
    return FlowModel("resflow", Chain(layers), dims, device)
