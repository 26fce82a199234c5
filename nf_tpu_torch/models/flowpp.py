"""Flow++ model builder (counterpart of ``nf_tpu/models/flowpp.py``).

* density mode: n x [ActNorm -> MixLogAttnCoupling(alt odd)];
* image mode (NHWC): ``multiscale``'s skeleton with n x [ActNorm ->
  InvertibleConv1x1 -> MixLogAttnCoupling] as its block.  At 32x32x1 and
  n = 32 that is 161 couplings.  With ``var_dequant`` a
  ``VariationalDequant`` comes before the skeleton's Logit: a training
  objective that draws noise on every forward, so a forward without a
  generator (an ``EvalProgram``'s) raises, as ``nf_tpu``'s does.

``cfg.scan`` / ``cfg.remat`` as RealNVP's, the scan period 4 in density
mode and 6 for images; ``compute_dtype`` is not read, as in ``nf_tpu``.
"""
from __future__ import annotations

from ..bijectors.conv1x1 import InvertibleConv1x1
from ..bijectors.flowpp_coupling import MixLogAttnCoupling
from ..bijectors.norm import ActNorm
from ..bijectors.vardequant import VariationalDequant
from .base import FlowModel
from .multiscale import multiscale, stage_folder, top_bijector


def build_flowpp(dims, datatype=None, cfg=None, device=None) -> FlowModel:
    n, K = cfg.layers, cfg.mixtures
    bf = getattr(cfg, "base_filters", 32)
    if datatype != "image":
        layers = [l for i in range(n) for l in (
            ActNorm(dims[-1], device=device),
            MixLogAttnCoupling(dims, odd=i % 2 != 0, base_filters=bf, n_mixtures=K,
                               device=device))]
        return FlowModel("flow++", top_bijector(stage_folder(cfg, 4)(layers), cfg), dims,
                         device)
    def block(n, dims, masking):
        """n x [ActNorm -> InvertibleConv1x1 -> MixLogAttnCoupling], the
        coupling parity alternating."""
        return [l for i in range(n) for l in (
            ActNorm(dims[-1], device=device),
            InvertibleConv1x1(dims[-1], device=device),
            MixLogAttnCoupling(dims, masking=masking, odd=i % 2 != 0, base_filters=bf,
                               n_mixtures=K, device=device))]

    head = ([VariationalDequant(dims, base_filters=bf, device=device)]
            if getattr(cfg, "var_dequant", False) else [])
    layers = head + multiscale(dims, n, block, stage_folder(cfg, 6))
    return FlowModel("flow++", top_bijector(layers, cfg), dims, device)
