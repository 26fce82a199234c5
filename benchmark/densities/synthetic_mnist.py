"""synthetic_mnist: stand-in 32x32x1 images (smooth blobs with strokes) on
the 8-bit grid, as the port's `data/images.py::synthetic_images` draws
them, in torch on the device (MNIST's files are not in the repo)."""
import math

import torch

DIMS = (32, 32, 1)


def draw(n, g, dev):
    side = 32
    yy, xx = torch.meshgrid(torch.arange(side, device=dev, dtype=torch.float32),
                            torch.arange(side, device=dev, dtype=torch.float32), indexing="ij")

    def col(lo, hi):
        return (lo + (hi - lo) * torch.rand(n, generator=g, device=dev)).view(n, 1, 1)

    cx, cy, sig, phase = col(8, side - 8), col(8, side - 8), col(2.0, 5.0), col(0.0, 2 * math.pi)
    blob = torch.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * sig ** 2))
    stroke = 0.5 + 0.5 * torch.sin(0.5 * (xx + 2 * yy) + phase)
    img = torch.clamp(0.7 * blob + 0.3 * blob * stroke, 0.0, 1.0)
    return torch.round(img[..., None] * 255.0) / 255.0
