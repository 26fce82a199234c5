"""RealNVP model builder (counterpart of ``nf_tpu/models/realnvp.py``).

* density mode: n x [BatchNorm(affine=False) -> AffineCoupling(alt odd)];
* image mode (NHWC): Logit(0.01, compress=True), then while the spatial
  size is above 8: n checkerboard couplings -> Squeeze2d -> n channelwise
  couplings; a final checkerboard block of n + 1 couplings; Unsqueeze2d
  back to the input's resolution.  Each coupling follows a non-affine
  BatchNorm.  At 32x32x1 and n = 32 that is 161 couplings.

``nf_tpu``'s ``scan`` (``ScannedChain``) and ``remat`` are not ported.
"""
from __future__ import annotations

from ..bijectors.coupling import AffineCoupling
from ..bijectors.elementwise import Logit
from ..bijectors.norm import BatchNorm
from ..bijectors.squeeze import Squeeze2d, Unsqueeze2d
from ..core.bijector import Chain
from .base import FlowModel


def _block(n, dims, masking, bf, device):
    """n x [BatchNorm -> AffineCoupling], the coupling parity alternating."""
    return [l for i in range(n) for l in (
        BatchNorm(dims[-1], affine=False, device=device),
        AffineCoupling(dims, masking=masking, odd=i % 2 != 0, base_filters=bf,
                       device=device))]


def build_realnvp(dims, datatype=None, cfg=None, device=None) -> FlowModel:
    for flag in ("scan", "remat"):
        if getattr(cfg, flag, False):
            raise NotImplementedError(f"RealNVP with {flag}=True is not ported yet")
    n = cfg.layers
    bf = getattr(cfg, "base_filters", 32)
    if datatype != "image":
        return FlowModel("realnvp", Chain(_block(n, dims, "checkerboard", bf, device)),
                         dims, device)
    h, w, c = dims
    layers = [Logit(eps=0.01, compress=True)]
    mid = (h, w, c)
    while max(mid[0], mid[1]) > 8:
        layers += _block(n, mid, "checkerboard", bf, device)
        layers.append(Squeeze2d(odd=False))
        mid = (mid[0] // 2, mid[1] // 2, mid[2] * 4)
        layers += _block(n, mid, "channelwise", bf, device)
    layers += _block(n + 1, mid, "checkerboard", bf, device)
    while mid[0] != h or mid[1] != w:
        layers.append(Unsqueeze2d(odd=False))
        mid = (mid[0] * 2, mid[1] * 2, mid[2] // 4)
    return FlowModel("realnvp", Chain(layers), dims, device)
