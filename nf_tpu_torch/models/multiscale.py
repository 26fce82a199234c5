"""The multi-scale image skeleton ``nf_tpu``'s RealNVP, Glow and Flow++
builders share (NHWC): Logit(0.01, compress=True), then while the spatial
size is above 8: a checkerboard block -> Squeeze2d -> a channelwise block;
a final checkerboard block of n + 1; Unsqueeze2d back to the input's
resolution.  At 32x32 and n = 32 that is 161 couplings."""
from __future__ import annotations

from ..bijectors.elementwise import Logit
from ..bijectors.squeeze import Squeeze2d, Unsqueeze2d


def multiscale(dims, n, block):
    """The skeleton's layers; ``block(n, dims, masking)`` gives the layers of
    one block of n couplings at ``dims`` (H, W, C)."""
    h, w, c = dims
    layers = [Logit(eps=0.01, compress=True)]
    mid = (h, w, c)
    while max(mid[0], mid[1]) > 8:
        layers += block(n, mid, "checkerboard")
        layers.append(Squeeze2d(odd=False))
        mid = (mid[0] // 2, mid[1] // 2, mid[2] * 4)
        layers += block(n, mid, "channelwise")
    layers += block(n + 1, mid, "checkerboard")
    while mid[0] != h or mid[1] != w:
        layers.append(Unsqueeze2d(odd=False))
        mid = (mid[0] * 2, mid[1] * 2, mid[2] // 4)
    return layers
