"""Work of one RealNVP request, from the configuration's shapes.

`model_flops`: the model's multiply-adds, 2 flops each, of one pass over
`rows` rows (log p and sampling run the same conditioners).  Per
coupling, dense (2-D): in*F + 4*F*F + F*2out per row; conv (image), over
the half's H'*W' pixels: 9*in*F + 4*9*F*F (the 3x3 convs) + F*2out (the
1x1 head).

`kernel_calls`: the port's kernels a pass of the served program needs,
each with its work: the whole fused stack once (2-D).  The image model's
work is all in its convs (`model_flops`).
"""
from __future__ import annotations

import math

from ..reference import realnvp as model
from . import kernels


def _couplings(cfg):
    for step in model.layers(cfg):
        if step["kind"] == "coupling":
            out, inp, hw = model._coupling_halves(step["dims"], step["masking"], step["odd"])
            yield out, inp, hw


def model_flops(cfg: dict, kind: str, rows: int) -> int:
    F = cfg["network_config"]["base_filters"]
    mac = 0
    for out, inp, hw in _couplings(cfg):
        if hw is None:
            mac += inp * F + 4 * F * F + F * 2 * out
        else:
            mac += math.prod(hw) * (9 * inp * F + 4 * 9 * F * F + F * 2 * out)
    return 2 * mac * rows


def kernel_calls(cfg: dict, kind: str, rows: int):
    """[(kernel group, work)] of one request."""
    if cfg["datatype"] == "image":
        return []
    F = cfg["network_config"]["base_filters"]
    halves = [(o, i) for o, i, _ in _couplings(cfg)][:2]
    n = sum(1 for _ in _couplings(cfg))
    return [("fused_stack", kernels.stack_work(n, cfg["dims"][0], F, halves, rows))]
