"""RealNVP model builder (counterpart of ``nf_tpu/models/realnvp.py``).

* density mode: n x [BatchNorm(affine=False) -> AffineCoupling(alt odd)];
* image mode (NHWC): ``multiscale``'s skeleton with n x [BatchNorm(affine=
  False) -> AffineCoupling] as its block.  At 32x32x1 and n = 32 that is
  161 couplings.

With ``cfg.scan`` each stage folds into ``scan_repeated`` over blocks of
4 layers (two couplings: the parity alternates), with ``cfg.remat`` each
block rematerialized; ``cfg.compute_dtype`` goes to the couplings'
conditioners.
"""
from __future__ import annotations

from ..bijectors.coupling import AffineCoupling
from ..bijectors.norm import BatchNorm
from .base import FlowModel
from .multiscale import multiscale, stage_folder, top_bijector

# [norm, coupling(even), norm, coupling(odd)]: nf_tpu's scan period
PERIOD = 4


def build_realnvp(dims, datatype=None, cfg=None, device=None) -> FlowModel:
    bf = getattr(cfg, "base_filters", 32)
    cd = getattr(cfg, "compute_dtype", None)
    fold = stage_folder(cfg, PERIOD)

    def block(n, dims, masking):
        """n x [BatchNorm -> AffineCoupling], the coupling parity alternating."""
        return [l for i in range(n) for l in (
            BatchNorm(dims[-1], affine=False, device=device),
            AffineCoupling(dims, masking=masking, odd=i % 2 != 0, base_filters=bf,
                           device=device, compute_dtype=cd))]

    layers = (multiscale(dims, cfg.layers, block, fold) if datatype == "image"
              else fold(block(cfg.layers, dims, "checkerboard")))
    return FlowModel("realnvp", top_bijector(layers, cfg), dims, device)
