"""RealNVP model builder (counterpart of ``nf_tpu/models/realnvp.py``),
density mode: n x [BatchNorm(affine=False) -> AffineCoupling(alt odd)]."""
from __future__ import annotations

from ..bijectors.coupling import AffineCoupling
from ..bijectors.norm import BatchNorm
from ..core.bijector import Chain
from .base import FlowModel


def build_realnvp(dims, datatype=None, cfg=None, device=None) -> FlowModel:
    if datatype == "image":
        raise NotImplementedError("the RealNVP image tier lands in a later slice")
    n_layers = cfg.layers
    bf = getattr(cfg, "base_filters", 32)
    layers = [l for i in range(n_layers) for l in (
        BatchNorm(dims[-1], affine=False, device=device),
        AffineCoupling(dims, odd=i % 2 != 0, base_filters=bf, device=device))]
    return FlowModel("realnvp", Chain(layers), dims, device)
