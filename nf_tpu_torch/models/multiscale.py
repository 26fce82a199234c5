"""What ``nf_tpu``'s builders share.

``multiscale`` is the multi-scale image skeleton of RealNVP, Glow and
Flow++ (NHWC): Logit(0.01, compress=True), then while the spatial size is
above 8: a checkerboard block -> Squeeze2d -> a channelwise block; a final
checkerboard block of n + 1; Unsqueeze2d back to the input's resolution.
At 32x32 and n = 32 that is 161 couplings.

``stage_folder`` and ``top_bijector`` carry ``nf_tpu``'s ``scan`` /
``remat`` rules: with ``scan`` every stage of repeated layers folds into
``scan_repeated(stage, period, remat)``; the model's bijector is then the
one folded stage itself when nothing else is left, else
``Chain(layers, remat=remat and not scan)``.
"""
from __future__ import annotations

from ..bijectors.elementwise import Logit
from ..bijectors.squeeze import Squeeze2d, Unsqueeze2d
from ..core.bijector import Chain, scan_repeated


def stage_folder(cfg, period: int):
    """stage -> the layers it adds: itself, or with ``cfg.scan`` one
    ``scan_repeated(stage, period, cfg.remat)``."""
    if not getattr(cfg, "scan", False):
        return list
    remat = getattr(cfg, "remat", False)
    return lambda stage: [scan_repeated(stage, period, remat=remat)]


def top_bijector(layers, cfg):
    """The model's bijector over ``layers`` (``nf_tpu``'s last lines)."""
    scan, remat = getattr(cfg, "scan", False), getattr(cfg, "remat", False)
    if scan and len(layers) == 1:
        return layers[0]
    return Chain(layers, remat=remat and not scan)


def multiscale(dims, n, block, fold=list):
    """The skeleton's layers; ``block(n, dims, masking)`` gives the layers of
    one block of n couplings at ``dims`` (H, W, C), and ``fold`` (a
    ``stage_folder``) what each block adds."""
    h, w, c = dims
    layers = [Logit(eps=0.01, compress=True)]
    mid = (h, w, c)
    while max(mid[0], mid[1]) > 8:
        layers += fold(block(n, mid, "checkerboard"))
        layers.append(Squeeze2d(odd=False))
        mid = (mid[0] // 2, mid[1] // 2, mid[2] * 4)
        layers += fold(block(n, mid, "channelwise"))
    layers += fold(block(n + 1, mid, "checkerboard"))
    while mid[0] != h or mid[1] != w:
        layers.append(Unsqueeze2d(odd=False))
        mid = (mid[0] * 2, mid[1] * 2, mid[2] // 4)
    return layers
