"""Planar flow model builder (counterpart of ``nf_tpu/models/planar.py``):
n planar transforms over the flattened dimension, nothing between them
(the reference builds a BatchNorm per layer and never uses it; nf_tpu
leaves it out, and so does the port)."""
from __future__ import annotations

import math

from ..bijectors.planar import PlanarTransform
from ..core.bijector import Chain
from .base import FlowModel


def build_planar(dims, datatype=None, cfg=None, device=None) -> FlowModel:
    dim = math.prod(dims)
    layers = [PlanarTransform(dim, device=device) for _ in range(cfg.layers)]
    return FlowModel("planar", Chain(layers), dims, device)
