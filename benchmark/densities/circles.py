"""circles: two concentric circles (radii 1.0 and 0.5), noise 0.08, scaled
by 0.6 (the port's `data/toy.py` sampler, in torch on the device)."""
import math

import torch

DIMS = (2,)


def draw(n, g, dev):
    t = 2.0 * math.pi * torch.rand(n, generator=g, device=dev)
    r = torch.where(torch.arange(n, device=dev) < n // 2, 1.0, 0.5)
    x = r * torch.cos(t) + 0.08 * torch.randn(n, generator=g, device=dev)
    y = r * torch.sin(t) + 0.08 * torch.randn(n, generator=g, device=dev)
    return torch.stack([x, y], dim=1) * 0.6
