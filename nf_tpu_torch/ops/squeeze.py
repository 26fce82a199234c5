"""Volume-preserving split / merge and space-to-depth reorderings, NHWC
(counterpart of ``nf_tpu/ops/squeeze.py``).

Checkerboard semantics: a 2x2 spatial block has positions
    a=(0,0)  b=(0,1)
    c=(1,0)  d=(1,1)
``checker_split`` does space-to-depth, then groups z0 = [a, d] and
z1 = [b, c], so a flattened half has ``nf_tpu``'s element order.
"""
from __future__ import annotations

import torch


def _space_to_depth(z):
    """(B, H, W, C) -> (B, H/2, W/2, 4C) with channel blocks [a, b, c, d]."""
    B, H, W, C = z.shape
    z = z.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
    return z.reshape(B, H // 2, W // 2, 4 * C)


def _depth_to_space(z):
    """Inverse of ``_space_to_depth``."""
    B, sH, sW, C4 = z.shape
    C = C4 // 4
    z = z.reshape(B, sH, sW, 2, 2, C).permute(0, 1, 3, 2, 4, 5)
    return z.reshape(B, sH * 2, sW * 2, C)


def channel_split(z, odd: bool = False):
    C = z.shape[-1]
    z0, z1 = z[..., :C // 2], z[..., C // 2:]
    return (z1, z0) if odd else (z0, z1)


def channel_merge(z0, z1, odd: bool = False):
    if odd:
        z0, z1 = z1, z0
    return torch.cat([z0, z1], dim=-1)


def checker_split(z, odd: bool = False):
    """(B,H,W,C) -> two (B,H/2,W/2,2C) maps grouping (a,d) and (b,c) cells."""
    C = z.shape[-1]
    za, zb, zc, zd = _space_to_depth(z).split(C, dim=-1)
    z0 = torch.cat([za, zd], dim=-1)
    z1 = torch.cat([zb, zc], dim=-1)
    return (z1, z0) if odd else (z0, z1)


def checker_merge(z0, z1, odd: bool = False):
    if odd:
        z0, z1 = z1, z0
    C = z0.shape[-1] // 2
    za, zd = z0[..., :C], z0[..., C:]
    zb, zc = z1[..., :C], z1[..., C:]
    return _depth_to_space(torch.cat([za, zb, zc, zd], dim=-1))


def squeeze1d(z, odd: bool = False):
    """(B, D) -> two (B, D/2) halves of alternating entries."""
    B, D = z.shape
    z = z.reshape(B, D // 2, 2)
    z0, z1 = z[:, :, 0], z[:, :, 1]
    return (z1, z0) if odd else (z0, z1)


def unsqueeze1d(z0, z1, odd: bool = False):
    if odd:
        z0, z1 = z1, z0
    z = torch.stack([z0, z1], dim=-1)
    return z.reshape(z.shape[0], -1)


def squeeze2d(z, odd: bool = False):
    """Space-to-depth, then split the 4C channels into [a,b] and [c,d]."""
    s = _space_to_depth(z)
    C2 = s.shape[-1] // 2
    z0, z1 = s[..., :C2], s[..., C2:]
    return (z1, z0) if odd else (z0, z1)


def unsqueeze2d(z0, z1, odd: bool = False):
    if odd:
        z0, z1 = z1, z0
    return _depth_to_space(torch.cat([z0, z1], dim=-1))
