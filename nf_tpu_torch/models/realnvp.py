"""RealNVP model builder (counterpart of ``nf_tpu/models/realnvp.py``).

* density mode: n x [BatchNorm(affine=False) -> AffineCoupling(alt odd)];
* image mode (NHWC): ``multiscale``'s skeleton with n x [BatchNorm(affine=
  False) -> AffineCoupling] as its block.  At 32x32x1 and n = 32 that is
  161 couplings.
"""
from __future__ import annotations

from ..bijectors.coupling import AffineCoupling
from ..bijectors.norm import BatchNorm
from ..core.bijector import Chain
from .base import FlowModel
from .multiscale import multiscale


def build_realnvp(dims, datatype=None, cfg=None, device=None) -> FlowModel:
    bf = getattr(cfg, "base_filters", 32)

    def block(n, dims, masking):
        """n x [BatchNorm -> AffineCoupling], the coupling parity alternating."""
        return [l for i in range(n) for l in (
            BatchNorm(dims[-1], affine=False, device=device),
            AffineCoupling(dims, masking=masking, odd=i % 2 != 0, base_filters=bf,
                           device=device))]

    layers = (multiscale(dims, cfg.layers, block) if datatype == "image"
              else block(cfg.layers, dims, "checkerboard"))
    return FlowModel("realnvp", Chain(layers), dims, device)
