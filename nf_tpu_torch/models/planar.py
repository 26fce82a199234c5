"""Planar flow model builder (counterpart of ``nf_tpu/models/planar.py``):
n planar transforms over the flattened dimension, nothing between them
(the reference builds a BatchNorm per layer and never uses it; nf_tpu
leaves it out, and so does the port).  ``cfg.scan`` folds the layers
into ``scan_repeated`` with period 1, ``cfg.remat`` rematerializes, by
``nf_tpu``'s rules."""
from __future__ import annotations

import math

from ..bijectors.planar import PlanarTransform
from .base import FlowModel
from .multiscale import stage_folder, top_bijector


def build_planar(dims, datatype=None, cfg=None, device=None) -> FlowModel:
    dim = math.prod(dims)
    layers = [PlanarTransform(dim, device=device) for _ in range(cfg.layers)]
    return FlowModel("planar", top_bijector(stage_folder(cfg, 1)(layers), cfg), dims, device)
