"""Fused attention forward on Hopper (counterpart of the kernel in
``nf_tpu/ops/pallas/attention.py``).

``nf_tpu_torch/csrc/attention.cu`` replaces ``_attn_kernel`` (launched by
``attention_pallas``): out = softmax(q k^T / sqrt(D)) v per (batch * head)
slice in f32, with the L x L scores kept out of device memory.

``AttentionFwd`` is the ``torch.autograd.Function``: its forward launches
the kernel; its backward recomputes through the plain version's autograd
(``ops/attention.py::attention_reference``), as ``nf_tpu``'s
``_attention_fused_bwd`` does: ``nf_tpu`` has no backward kernel for
attention.  ``launch`` checks device, dtype, shape and contiguity and
raises on anything the kernel does not take: it covers any L >= 1 and
1 <= D <= ``MAX_HEAD_DIM``.  ``LAUNCHES`` counts the launches where they
happen, and ``launches_by_len`` splits them by sequence length.

The kernel is one pass with an online softmax, both products on tensor
cores in 3xTF32 (f32 accuracy), a warp per 16 query rows; ``tiling``
picks its blocks and key tiles, and the CPU tests walk them
(tests/test_torch_attention.py).

Bound (H100 SXM): per slice 4 L^2 D flops for q k^T and p v, 3 f32
operations and one exp per score, and q, k, v, out moved once: at L = 256,
D = 8 operations bound it; at L = 64 and 16, bytes.
"""
from __future__ import annotations

import ctypes
from collections import Counter

import torch

from . import _build

LAUNCHES = {"attention_fwd": 0}
launches_by_len: Counter = Counter()
MAX_HEAD_DIM = 128    # D is zero-padded to a multiple of 8, up to this
WARP_ROWS = 16        # query rows of one warp (the mma's m)
BLOCK_ROWS = 64       # query rows of one block: 4 warps
SMEM_LIMIT = 232448   # dynamic shared memory one Hopper block may use
TILE_BYTES = 49152    # two staged tiles' k and v of a block, where a tile allows


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    launches_by_len.clear()


def padded_dim(D: int) -> int:
    """The kernel's head width DP: D rounded up to a multiple of 8."""
    return -(-D // 8) * 8


def key_chunk(dp: int) -> int:
    """Keys per softmax step, whose scores stay in registers
    (csrc/attention.cu's key_chunk)."""
    return 64 if dp <= 64 else 32


def tiling(L: int, D: int):
    """The kernel's (S, R, T): slices per block, query rows of a slice per
    block (S R = 64, four warps of 16 rows), keys per staged tile.  Up to
    16 keys a block takes 4 slices of one warp each, up to 32 keys 2 slices
    of two warps; longer slices take 64 rows of one slice per block and
    ``ceil(L / 64)`` neighbouring blocks.  A tile holds the whole slice,
    rounded up to 8 keys, where two tiles' k and v fit ``TILE_BYTES``; else
    the most whole ``key_chunk``s that fit (at least one), double-buffered.
    The warps walk a tile ``key_chunk`` keys at a time."""
    R = 16 if L <= 16 else 32 if L <= 32 else BLOCK_ROWS
    S = BLOCK_ROWS // R
    dp = padded_dim(D)
    kc = key_chunk(dp)
    fit = TILE_BYTES // (2 * 2 * 4 * (dp + 4) * S) // kc * kc
    return S, R, min(-(-L // 8) * 8, max(fit, kc))


def smem_bytes(L: int, D: int) -> int:
    """Dynamic shared memory of one block; the kernel computes the same:
    the block's 64 q / out rows and one (two when the slice has more than
    one tile) staged k and v tiles of its S slices, rows padded to DP + 4
    floats."""
    S, _, T = tiling(L, D)
    return 4 * (padded_dim(D) + 4) * (BLOCK_ROWS + (2 if L > T else 1) * 2 * S * T)


def covers(L: int, D: int) -> bool:
    """Whether the kernel takes (L, D): any L >= 1 and any D up to
    ``MAX_HEAD_DIM`` (``launch`` also refuses a grid past 2^31 - 1 blocks)."""
    return L >= 1 and 1 <= D <= MAX_HEAD_DIM


def _fn():
    fn = _build.load("attention").nf_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def launch(q, k, v):
    """The kernel on contiguous float32 (BH, L, D) q, k, v on one CUDA
    device: out (BH, L, D)."""
    if not q.is_cuda:
        raise ValueError(f"the attention kernel needs a CUDA tensor, got {q.device}")
    if q.dim() != 3:
        raise ValueError(f"the attention kernel takes (BH, L, D) slices, got {tuple(q.shape)}")
    BH, L, D = q.shape
    if not covers(L, D):
        raise NotImplementedError(f"the attention kernel covers L >= 1 and 1 <= D <= "
                                  f"{MAX_HEAD_DIM}, got L = {L}, D = {D}")
    for t in (q, k, v):
        if (t.device != q.device or t.dtype != torch.float32 or t.shape != q.shape
                or not t.is_contiguous()):
            raise ValueError(f"the attention kernel takes contiguous float32 {tuple(q.shape)} "
                             f"q, k, v on {q.device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    out = torch.empty_like(q)
    if BH == 0:
        return out
    ptrs = [t.data_ptr() for t in (q, k, v, out)]
    vec = D % 4 == 0 and all(p % 16 == 0 for p in ptrs)
    with torch.cuda.device(q.device):
        err = _fn()(*ptrs, BH, L, D, *tiling(L, D), int(vec),
                    torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention_fwd kernel failed to launch: CUDA error {err}")
    LAUNCHES["attention_fwd"] += 1
    launches_by_len[L] += 1
    return out


class AttentionFwd(torch.autograd.Function):
    """The kernel's forward; the backward through the plain version."""

    @staticmethod
    def forward(ctx, q, k, v):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        ctx.save_for_backward(q, k, v)
        return launch(q, k, v)

    @staticmethod
    def backward(ctx, g):
        from ..attention import attention_reference

        with torch.enable_grad():
            q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
            out = attention_reference(q, k, v)
        return torch.autograd.grad(out, (q, k, v), g)
