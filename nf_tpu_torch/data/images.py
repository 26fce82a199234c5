"""Image dataset readers (counterpart of ``nf_tpu/data/images.py``): MNIST
from its IDX files (plain or ``.gz``), zero-padded 28 -> 32, and CIFAR-10
from its binary batches, pixels scaled to [0, 1], laid out NHWC float32.

Where the files are not under ``data_root``, ``synthetic_images`` makes
deterministic stand-ins of the same shape, dtype and 8-bit grid, the same
arrays nf_tpu makes for the same seed.  ``mnist16`` / ``cifar16`` take
every second pixel of each axis, which keeps the 8-bit grid.
"""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

MNIST_DIMS = (32, 32, 1)
CIFAR10_DIMS = (32, 32, 3)


def _maybe_open(path: str):
    if os.path.exists(path):
        return open(path, "rb")
    if os.path.exists(path + ".gz"):
        return gzip.open(path + ".gz", "rb")
    return None


def _read_idx_images(f) -> np.ndarray:
    magic, n, rows, cols = struct.unpack(">IIII", f.read(16))
    if magic != 2051:
        raise ValueError(f"bad IDX image magic {magic:#x}")
    buf = f.read(n * rows * cols)
    return np.frombuffer(buf, dtype=np.uint8).reshape(n, rows, cols)


def load_mnist(data_root: str, train: bool = True) -> np.ndarray | None:
    """float32[N, 32, 32, 1] in [0, 1], 28x28 zero-padded to 32x32; None
    if the IDX files are not on disk."""
    stem = "train-images-idx3-ubyte" if train else "t10k-images-idx3-ubyte"
    for sub in ("MNIST/raw", "mnist", ""):
        f = _maybe_open(os.path.join(data_root, sub, stem))
        if f is not None:
            with f:
                raw = _read_idx_images(f)
            x = raw.astype(np.float32) / 255.0
            x = np.pad(x, ((0, 0), (2, 2), (2, 2)))
            return x[..., None]
    return None


def load_cifar10(data_root: str, train: bool = True) -> np.ndarray | None:
    """float32[N, 32, 32, 3] in [0, 1]; None if the binary batches are not
    on disk."""
    names = ([f"data_batch_{i}.bin" for i in range(1, 6)]
             if train else ["test_batch.bin"])
    chunks = []
    for sub in ("cifar-10-batches-bin", "cifar10", ""):
        base = os.path.join(data_root, sub)
        if not all(os.path.exists(os.path.join(base, n)) for n in names):
            continue
        for n in names:
            raw = np.fromfile(os.path.join(base, n), dtype=np.uint8)
            rec = raw.reshape(-1, 3073)[:, 1:]  # drop the label byte
            chw = rec.reshape(-1, 3, 32, 32)
            chunks.append(np.transpose(chw, (0, 2, 3, 1)))
        return np.concatenate(chunks).astype(np.float32) / 255.0
    return None


def synthetic_images(name: str, n: int, seed: int) -> np.ndarray:
    """Deterministic stand-in images (smooth blobs with strokes) on the
    8-bit grid, with the shape, dtype and range of the real datasets."""
    dims = MNIST_DIMS if name == "mnist" else CIFAR10_DIMS
    h, w, c = dims
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    cx = rng.uniform(8, w - 8, size=(n, 1, 1)).astype(np.float32)
    cy = rng.uniform(8, h - 8, size=(n, 1, 1)).astype(np.float32)
    sig = rng.uniform(2.0, 5.0, size=(n, 1, 1)).astype(np.float32)
    blob = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * sig ** 2))
    phase = rng.uniform(0, 2 * np.pi, size=(n, 1, 1)).astype(np.float32)
    stroke = 0.5 + 0.5 * np.sin(0.5 * (xx + 2 * yy) + phase)
    img = np.clip(0.7 * blob + 0.3 * blob * stroke, 0.0, 1.0)
    out = np.repeat(img[..., None], c, axis=-1)
    if c == 3:  # decorrelate the channels a little
        tint = rng.uniform(0.5, 1.0, size=(n, 1, 1, 3)).astype(np.float32)
        out = out * tint
    # on the 8-bit grid, as the real datasets: a continuous stand-in would
    # make the image NLL unbounded and bits per dim meaningless
    out = np.round(out * 255.0) / 255.0
    return out.astype(np.float32)


IMAGE_DATASETS = {
    "mnist": MNIST_DIMS,
    "cifar10": CIFAR10_DIMS,
    # every second pixel (16x16), on the same 8-bit grid
    "mnist16": (16, 16, 1),
    "cifar16": (16, 16, 3),
}


def load_images(name: str, data_root: str, seed: int = 0,
                synthetic_n: int = 8192) -> tuple[np.ndarray, bool]:
    """Returns (images NHWC float32 in [0, 1], is_real)."""
    if name not in IMAGE_DATASETS:
        raise KeyError(name)
    sub = name.endswith("16")
    base = {"mnist": "mnist", "mnist16": "mnist",
            "cifar10": "cifar10", "cifar16": "cifar10"}[name]
    if base == "mnist":
        x = load_mnist(data_root)
    else:
        x = load_cifar10(data_root)
    if x is None:
        x, is_real = synthetic_images(base, synthetic_n, seed), False
    else:
        is_real = True
    if sub:
        # subsampling, not averaging, keeps the 8-bit grid
        x = np.ascontiguousarray(x[:, ::2, ::2, :])
    return x, is_real
