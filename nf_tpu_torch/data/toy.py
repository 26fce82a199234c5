"""NumPy samplers of the toy densities (counterpart of
``nf_tpu/data/toy.py``): the same formulas and the same draws, so a
``numpy.random.Generator`` in a given state gives nf_tpu's samples bit for
bit.  The native tier (``csrc/sampler.cpp`` through ``data/native.py``)
implements the same densities with its own RNG.

Every sampler is ``fn(n, rng) -> float32[(n,) + dims]`` with an explicit
``numpy.random.Generator``; nothing reads a global RNG.
"""
from __future__ import annotations

import numpy as np

_TAU = 2.0 * np.pi


def sample_circles(n: int, rng: np.random.Generator) -> np.ndarray:
    """Two concentric circles (radii 1.0 / 0.5), Gaussian noise 0.08,
    scaled by 0.6 (sklearn's ``make_circles(factor=0.5, noise=0.08)``)."""
    n_out = n // 2
    t = rng.uniform(0.0, _TAU, size=n)
    r = np.where(np.arange(n) < n_out, 1.0, 0.5)
    x = r * np.cos(t) + rng.normal(0.0, 0.08, size=n)
    y = r * np.sin(t) + rng.normal(0.0, 0.08, size=n)
    return (np.stack([x, y], axis=1) * 0.6).astype(np.float32)


def sample_moons(n: int, rng: np.random.Generator) -> np.ndarray:
    """Two interleaved half-moons, noise 0.08, then ``(v - 0.5) / 2``."""
    n_a = n // 2
    t = rng.uniform(0.0, np.pi, size=n)
    upper = np.arange(n) < n_a
    x = np.where(upper, np.cos(t), 1.0 - np.cos(t))
    y = np.where(upper, np.sin(t), -np.sin(t) + 0.5)
    x = x + rng.normal(0.0, 0.08, size=n)
    y = y + rng.normal(0.0, 0.08, size=n)
    pts = np.stack([x, y], axis=1)
    return ((pts - 0.5) / 2.0).astype(np.float32)


def sample_normals(n: int, rng: np.random.Generator) -> np.ndarray:
    """Ring of eight isotropic Gaussians, radius 0.7, sigma 0.1."""
    k = rng.integers(0, 8, size=n)
    cx = 0.7 * np.cos(_TAU * k / 8.0)
    cy = 0.7 * np.sin(_TAU * k / 8.0)
    pts = np.stack([cx, cy], axis=1) + rng.normal(0.0, 0.1, size=(n, 2))
    return pts.astype(np.float32)


def sample_swiss(n: int, rng: np.random.Generator) -> np.ndarray:
    """Swiss roll (sklearn's formula), noise 0.08, scaled into the unit box."""
    t = 1.5 * np.pi * (1.0 + 2.0 * rng.uniform(0.0, 1.0, size=n))
    x = t * np.cos(t) + rng.normal(0.0, 0.08, size=n)
    y = 21.0 * rng.uniform(0.0, 1.0, size=n) + rng.normal(0.0, 0.08, size=n)
    z = t * np.sin(t) + rng.normal(0.0, 0.08, size=n)
    pts = np.stack([x * 0.07, y * 0.07 - 1.0, z * 0.07], axis=1)
    return pts.astype(np.float32)


def sample_s_curve(n: int, rng: np.random.Generator) -> np.ndarray:
    """S-curve (sklearn's formula), noise 0.08, scaled into the unit box."""
    t = 3.0 * np.pi * (rng.uniform(0.0, 1.0, size=n) - 0.5)
    x = np.sin(t) + rng.normal(0.0, 0.08, size=n)
    y = 2.0 * rng.uniform(0.0, 1.0, size=n) + rng.normal(0.0, 0.08, size=n)
    z = np.sign(t) * (np.cos(t) - 1.0) + rng.normal(0.0, 0.08, size=n)
    pts = np.stack([x * 0.7, (y - 1.0) * 0.7, z * 0.35], axis=1)
    return pts.astype(np.float32)


# name -> (sampler, event dims, loader datatype)
TOY_SAMPLERS = {
    "circles": (sample_circles, (2,), "2d"),
    "moons": (sample_moons, (2,), "2d"),
    "normals": (sample_normals, (2,), "2d"),
    "swiss": (sample_swiss, (3,), "3d"),
    "s_curve": (sample_s_curve, (3,), "3d"),
}
