"""The model's state, drawn from the seed on the device in one call.

`draw(specs, seed, device)` takes the reference's leaf list (key, shape,
low, high), draws one uniform block for all of them from a
`torch.Generator` on `device`, and maps each leaf's slice to [low, high].
The served model loads these tensors; the reference reads the same ones.
"""
from __future__ import annotations

import math

import torch


def generator(seed: int, device, stream: int = 0) -> torch.Generator:
    """A generator on ``device`` seeded from the run's seed and a stream
    number, so that each use of the seed draws its own numbers."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (1 << 63))
    return g


@torch.no_grad()
def draw(specs, seed: int, device) -> dict:
    """{key: float32 tensor} for every (key, shape, low, high) in specs."""
    sizes = [math.prod(shape) for _, shape, _, _ in specs]
    block = torch.rand(sum(sizes), generator=generator(seed, device, 1),
                       device=device, dtype=torch.float32)
    leaves = [part.view(shape) for part, (_, shape, _, _) in
              zip(block.split(sizes), specs)]
    torch._foreach_mul_(leaves, [hi - lo for _, _, lo, hi in specs])
    torch._foreach_add_(leaves, [lo for _, _, lo, _ in specs])
    return {key: leaf for (key, _, _, _), leaf in zip(specs, leaves)}
