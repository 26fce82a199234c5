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
raises on anything the kernels do not take: they cover any L >= 1 and
D >= 1 (only a grid past the card's limits is refused).  ``LAUNCHES``
counts the launches where they happen, ``launches_by_len`` splits them by
sequence length and ``launches_by_path`` by kernel.

Up to D = ``ONE_PASS_MAX_DIM`` (128) the kernel is one pass with an
online softmax, both products on tensor cores in 3xTF32 (f32 accuracy), a
warp per 16 query rows; ``tiling`` picks its blocks and key tiles.  Past
it, ``attention_fwd_wide_kernel`` splits the output's columns into blocks
of ``WIDE_COLS`` over a second grid dimension, each block recomputing its
rows' scores over the whole D (``wide_tiling``).  The CPU tests walk both
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
# launches by kernel: "one_pass" (D <= ONE_PASS_MAX_DIM), "column_blocks" (past it)
launches_by_path: Counter = Counter()
ONE_PASS_MAX_DIM = 128  # the one-pass kernel's D, zero-padded to a multiple of 8
WIDE_COLS = 128       # output columns of a block of the wide kernel, and its score chunk
WIDE_KEYS = 32        # keys per staged tile of the wide kernel
WARP_ROWS = 16        # query rows of one warp (the mma's m)
BLOCK_ROWS = 64       # query rows of one block: 4 warps
SMEM_LIMIT = 232448   # dynamic shared memory one Hopper block may use
TILE_BYTES = 49152    # two staged tiles' k and v of a block, where a tile allows


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    launches_by_len.clear()
    launches_by_path.clear()


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


def wide_tiling(L: int):
    """The wide kernel's (S, R, T) past ``ONE_PASS_MAX_DIM``: slices and rows
    as ``tiling``, and T = min(WIDE_KEYS, L rounded up to 8) keys per
    staged tile, walked in one chunk."""
    R = 16 if L <= 16 else 32 if L <= 32 else BLOCK_ROWS
    return BLOCK_ROWS // R, R, min(WIDE_KEYS, -(-L // 8) * 8)


def path(D: int) -> str:
    """The kernel that takes head width D: 'one_pass' or 'column_blocks'."""
    return "one_pass" if D <= ONE_PASS_MAX_DIM else "column_blocks"


def smem_bytes(L: int, D: int) -> int:
    """Dynamic shared memory of one block; the kernels compute the same.
    One pass: the block's 64 q / out rows and one (two when the slice has
    more than one tile) staged k and v tiles of its S slices, rows padded
    to DP + 4 floats.  Column blocks: the 64 q rows, one k and one v tile,
    rows of WIDE_COLS + 4 floats, whatever D."""
    if path(D) == "column_blocks":
        S, _, T = wide_tiling(L)
        return 4 * (WIDE_COLS + 4) * (BLOCK_ROWS + 2 * S * T)
    S, _, T = tiling(L, D)
    return 4 * (padded_dim(D) + 4) * (BLOCK_ROWS + (2 if L > T else 1) * 2 * S * T)


def grid(BH: int, L: int, D: int):
    """The launch's grid: (row blocks, column blocks)."""
    if path(D) == "column_blocks":
        S, R, _ = wide_tiling(L)
        return -(-BH // S) * -(-L // R), -(-D // WIDE_COLS)
    S, R, _ = tiling(L, D)
    return -(-BH // S) * -(-L // R), 1


def covers(L: int, D: int) -> bool:
    """Whether the kernels take (L, D): any L >= 1 and D >= 1 (``launch``
    also refuses a grid past the card's 2^31 - 1 by 65,535 blocks)."""
    return L >= 1 and D >= 1


def _fn(name: str):
    fn = getattr(_build.load("attention"), name)
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
    for t in (q, k, v):
        if (t.device != q.device or t.dtype != torch.float32 or t.shape != q.shape
                or not t.is_contiguous()):
            raise ValueError(f"the attention kernel takes contiguous float32 {tuple(q.shape)} "
                             f"q, k, v on {q.device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    out = torch.empty_like(q)
    if BH == 0 or L == 0 or D == 0:
        return out
    rows, cols = grid(BH, L, D)
    if rows > 2 ** 31 - 1 or cols > 65535:
        raise ValueError(f"attention: a ({BH}, {L}, {D}) call needs a grid of {rows} x {cols} "
                         "blocks, past the card's 2^31 - 1 x 65,535")
    ptrs = [t.data_ptr() for t in (q, k, v, out)]
    vec = D % 4 == 0 and all(p % 16 == 0 for p in ptrs)
    kernel = path(D)
    wide = kernel == "column_blocks"
    with torch.cuda.device(q.device):
        err = _fn("nf_attention_fwd_wide" if wide else "nf_attention_fwd")(
            *ptrs, BH, L, D, *(wide_tiling(L) if wide else tiling(L, D)), int(vec),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention_fwd kernel failed to launch: CUDA error {err}")
    LAUNCHES["attention_fwd"] += 1
    launches_by_len[L] += 1
    launches_by_path[kernel] += 1
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
