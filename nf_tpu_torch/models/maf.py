"""MAF model builder (counterpart of ``nf_tpu/models/maf.py``).

* density mode: n x [BatchNorm(affine=False) -> AutoregressiveTransform];
* image mode only with ``cfg.allow_image`` (nf_tpu's flattened-pixel
  variant; without it image data raises, as in nf_tpu): Logit(0.01,
  compress=True) -> Flatten -> n x [BatchNorm -> AutoregressiveTransform
  (D = H*W*C)] -> Inverted(Flatten), so the latent keeps the image shape.
  Sampling costs D sequential MADE passes per layer.

``cfg.scan`` folds the stack into ``scan_repeated`` over [BatchNorm,
AutoregressiveTransform] blocks, ``cfg.remat`` rematerializes (each block,
or each layer unscanned), by ``nf_tpu``'s rules.
"""
from __future__ import annotations

import math

from ..bijectors.elementwise import Logit
from ..bijectors.made import AutoregressiveTransform
from ..bijectors.norm import BatchNorm
from ..bijectors.squeeze import Flatten
from ..core.bijector import Chain, Inverted
from .base import FlowModel
from .multiscale import stage_folder, top_bijector


def _stack(n, d, bf, resample_masks, device):
    return [l for _ in range(n) for l in (
        BatchNorm(d, affine=False, device=device),
        AutoregressiveTransform(d, base_filters=bf, resample_masks=resample_masks,
                                device=device))]


def build_maf(dims, datatype=None, cfg=None, device=None) -> FlowModel:
    bf = cfg.base_filters
    if datatype != "image":
        layers = _stack(cfg.layers, dims[-1], bf, cfg.resample_masks, device)
        return FlowModel("maf", top_bijector(stage_folder(cfg, 2)(layers), cfg), dims,
                         device)
    if not cfg.allow_image:
        raise NotImplementedError(
            "MAF for image data is not supported by the reference "
            "(flows/maf.py:131-132); opt in to the flattened-pixel "
            "variant with network.allow_image=true")
    # nf_tpu's image branch keeps fixed masks whatever resample_masks says
    stage = stage_folder(cfg, 2)(_stack(cfg.layers, math.prod(dims), bf, False, device))
    layers = [Logit(eps=0.01, compress=True), Flatten(dims)] + stage + [Inverted(Flatten(dims))]
    return FlowModel("maf", Chain(layers, remat=cfg.remat and not cfg.scan), dims, device)
