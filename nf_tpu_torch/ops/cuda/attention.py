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
raises on anything the kernel does not take: D in ``HEAD_DIMS``, L up to
``MAX_LEN``.  ``LAUNCHES`` counts the launches where they happen, and
``launches_by_len`` splits them by sequence length.

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
HEAD_DIMS = (2, 4, 8, 16, 32, 64)   # the kernel's template instantiations
MAX_LEN = 1024                      # nf_tpu's limit (attention.py:9-11)
MIN_THREADS = 128     # a block runs at least this many query rows where L allows
ROWS_PER_SLICE = 256  # query rows of one slice per block (the block's max threads)
TILE_FLOATS = 8192    # shared memory for the staged keys and values: 32 KB


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    launches_by_len.clear()


def tiling(L: int, D: int):
    """The kernel's (S, R, T): slices per block, query rows of a slice per
    block, keys per staged tile.  Short sequences pack several slices into
    one block of at least ``MIN_THREADS`` rows; long ones split their rows
    over ``ceil(L / R)`` blocks; a tile of keys and values of all S slices
    fills at most ``TILE_FLOATS``."""
    S = max(1, MIN_THREADS // L)
    R = min(L, ROWS_PER_SLICE)
    T = min(L, TILE_FLOATS // (2 * D * S))
    return S, R, T


def _fn():
    fn = _build.load("attention").nf_attention_fwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
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
    if D not in HEAD_DIMS or not 1 <= L <= MAX_LEN:
        raise NotImplementedError(f"the attention kernel covers D in {HEAD_DIMS} and 1 <= L <= "
                         f"{MAX_LEN}, got L = {L}, D = {D}")
    for t in (q, k, v):
        if (t.device != q.device or t.dtype != torch.float32 or t.shape != q.shape
                or not t.is_contiguous()):
            raise ValueError(f"the attention kernel takes contiguous float32 {tuple(q.shape)} "
                             f"q, k, v on {q.device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    out = torch.empty_like(q)
    if BH == 0:
        return out
    with torch.cuda.device(q.device):
        err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BH, L, D,
                    *tiling(L, D), torch.cuda.current_stream().cuda_stream)
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
