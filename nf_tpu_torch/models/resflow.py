"""Residual Flow model builder (counterpart of ``nf_tpu/models/resflow.py``).

* density mode: n x [ActNorm -> InvertibleResLinear(coeff=cfg.spnorm_coeff,
  estimator=cfg.logdet)];
* image mode only with ``cfg.allow_image`` (``nf_tpu``'s opt-in; without it
  image data raises, as in ``nf_tpu``): Logit(0.01, compress=True) ->
  Squeeze2d (4C channels at H/2 x W/2) -> n x [ActNorm(4C) ->
  InvertibleResConv2d(4C, 4C, spatial=(H/2, W/2))] -> Unsqueeze2d.

``cfg.scan`` folds the blocks into ``scan_repeated`` over [ActNorm, block]
pairs, ``cfg.remat`` rematerializes, by ``nf_tpu``'s rules.
"""
from __future__ import annotations

from ..bijectors.elementwise import Logit
from ..bijectors.iresblock import InvertibleResConv2d, InvertibleResLinear
from ..bijectors.norm import ActNorm
from ..bijectors.squeeze import Squeeze2d, Unsqueeze2d
from ..core.bijector import Chain
from .base import FlowModel
from .multiscale import stage_folder, top_bijector


def build_resflow(dims, datatype=None, cfg=None, device=None) -> FlowModel:
    kw = dict(base_filters=cfg.base_filters, coeff=cfg.spnorm_coeff,
              logdet_estimator=cfg.logdet, device=device)
    if datatype == "image":
        if not cfg.allow_image:
            raise NotImplementedError(
                "ResFlow for image data is not supported by the reference "
                "(flows/resflow.py:17-19); opt in to the conv variant with "
                "network.allow_image=true")
        c4 = dims[-1] * 4
        spatial = (dims[0] // 2, dims[1] // 2)
        stage = stage_folder(cfg, 2)([l for _ in range(cfg.layers) for l in (
            ActNorm(c4, device=device),
            InvertibleResConv2d(c4, c4, spatial=spatial, **kw))])
        layers = ([Logit(eps=0.01, compress=True), Squeeze2d(odd=False)] + stage
                  + [Unsqueeze2d(odd=False)])
        return FlowModel("resflow", Chain(layers, remat=cfg.remat and not cfg.scan), dims,
                         device)
    D = dims[-1]
    layers = [l for _ in range(cfg.layers) for l in (
        ActNorm(D, device=device), InvertibleResLinear(D, D, **kw))]
    return FlowModel("resflow", top_bijector(stage_folder(cfg, 2)(layers), cfg), dims, device)
