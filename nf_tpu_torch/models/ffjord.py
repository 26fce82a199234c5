"""FFJORD model builder (counterpart of ``nf_tpu/models/ffjord.py``).

* density mode: n x [ActNorm -> CNF] over the time grid
  ``linspace(t0, t1, ceil((t1 - t0) / stepsize) + 1)`` in float32;
* image mode only with ``cfg.allow_image`` (``nf_tpu``'s opt-in; without it
  image data raises, as in ``nf_tpu``): Logit(0.01, compress=True), then
  n x [ActNorm -> CNF with the conv ODENet over NHWC].

``nf_tpu`` runs no Pallas kernel here, so the port runs the eager chain:
every solve is ATen ops on the card.  ``cfg.scan`` folds the density
stack into ``scan_repeated`` over [ActNorm, CNF] pairs; the image opt-in
ignores it, and ``cfg.remat`` rematerializes, by ``nf_tpu``'s rules.
"""
from __future__ import annotations

import numpy as np

from ..bijectors.cnf import CNF
from ..bijectors.elementwise import Logit
from ..bijectors.norm import ActNorm
from ..core.bijector import Chain
from .base import FlowModel
from .multiscale import stage_folder, top_bijector


def time_grid(cfg) -> np.ndarray:
    steps = int(np.ceil((cfg.t1 - cfg.t0) / cfg.stepsize)) + 1
    return np.linspace(cfg.t0, cfg.t1, steps, dtype=np.float32)


def build_ffjord(dims, datatype=None, cfg=None, device=None) -> FlowModel:
    is_image = datatype == "image"
    if is_image and not cfg.allow_image:
        raise NotImplementedError(
            "FFJORD for image data is not supported by the reference "
            "(flows/ffjord.py:24-26); opt in to the conv-ODENet variant "
            "with network.allow_image=true")
    times = time_grid(cfg)
    layers = [Logit(eps=0.01, compress=True)] if is_image else []
    for _ in range(cfg.layers):
        layers.append(ActNorm(dims[-1], device=device))
        layers.append(CNF(dims, times, solver=cfg.solver, trace_estimator=cfg.trace,
                          backprop=cfg.backprop, base_filters=cfg.base_filters,
                          rtol=cfg.rtol, atol=cfg.atol, device=device))
    if is_image:
        return FlowModel("ffjord", Chain(layers, remat=cfg.remat), dims, device)
    return FlowModel("ffjord", top_bijector(stage_folder(cfg, 2)(layers), cfg), dims, device)
