"""Fixed-trip bisection for monotone scalar inverses (counterpart of
``nf_tpu/ops/bisect.py``): 64 halvings of a [-1e3, 1e3] bracket reach far
below 1e-4; no early exit, so nothing is read back to the host."""
from __future__ import annotations

import torch


def bisect_monotone(fn, target: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                    n_iters: int = 64) -> torch.Tensor:
    """Solve fn(x) = target for a monotone-increasing elementwise ``fn``;
    ``lo`` / ``hi`` bracket the root.  Returns the midpoint after
    ``n_iters`` halvings."""
    for _ in range(n_iters):
        mid = (lo + hi) * 0.5
        val = fn(mid)
        lo = torch.where(val < target, mid, lo)
        hi = torch.where(val >= target, mid, hi)
    return (lo + hi) * 0.5
