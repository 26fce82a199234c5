#!/usr/bin/env python3
"""Time the PyTorch port's invertible 1x1 conv inverse on one NVIDIA card,
two ways, at glow-img32x3's three scales (B = 1024: 32x32x3, 16x16x12,
8x8x48):

* ``solve``: nf_tpu's formulation, two triangular solves of the C x C
  factors against all N = B*H*W pixel vectors (``solve_triangular`` with a
  (C, N) right-hand side);
* ``port``: ``InvertibleConv1x1.inverse``, the C x C triangular inverses
  formed against the identity and applied as one matmul.

    python3 conv1x1_inverse_probe.py      # from the root of the repository

Prints one JSON line with wall ms per call (after a synchronize, 2 calls
after one warm-up; 1 call for a path slower than a second), the largest
difference between the two, and the card's name and power limit.
"""
import json
import subprocess
import sys
import time

import torch

SHAPES = [(32, 3), (16, 12), (8, 48)]   # (H = W, C) of glow-img32x3's scales
BATCH = 1024


def wall_ms(fn):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    once = time.perf_counter() - t0
    if once > 1.0:
        return once * 1e3
    t0 = time.perf_counter()
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / 2


def solve_inverse(conv, y):
    P, L, U = conv.factors()
    rhs = P.T @ y.reshape(-1, conv.num_channels).T
    z = torch.linalg.solve_triangular(L, rhs, upper=False, unitriangular=True)
    return torch.linalg.solve_triangular(U, z, upper=True).T.reshape(y.shape)


def main():
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    from nf_tpu_torch.bijectors.conv1x1 import InvertibleConv1x1

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    g = torch.Generator(device=dev).manual_seed(0)
    rows = []
    with torch.no_grad():
        for hw, c in SHAPES:
            conv = InvertibleConv1x1(c, device=dev)
            conv.init(g)
            y = torch.randn(BATCH, hw, hw, c, generator=g, device=dev)
            rows.append({"shape": [BATCH, hw, hw, c],
                         "solve_ms": wall_ms(lambda: solve_inverse(conv, y)),
                         "port_ms": wall_ms(lambda: conv.inverse(y)),
                         "max_abs_diff": float((solve_inverse(conv, y)
                                                - conv.inverse(y)[0]).abs().max())})
    print(json.dumps({"conv1x1_inverse": rows, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
