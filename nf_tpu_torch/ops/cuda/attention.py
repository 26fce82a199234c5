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
D >= 1 (and refuse a grid past the card's limits).  ``LAUNCHES``
counts the launches where they happen; each launch is the span
``launch.attention_fwd.<path(D)>`` (``utils/tracing.py``).

Up to D = ``ONE_PASS_MAX_DIM`` (128) the kernel is one pass with an
online softmax, both products on tensor cores in 3xTF32 (f32 accuracy), a
warp per 16 query rows; ``tiling`` picks its blocks and key tiles.  Past
it ``csrc/attention_wide.cu``: a block of 16 warps owns 16 RT query rows
of one slice, stages them once and streams the keys and values through a
two-stage ring; the warps of a row tile form the scores over chunks of D,
the softmax passes p through shared memory, and the same warps each own a
slab of output columns for p v (``wide_tiling``, ``wide_chunks``,
``wide_slabs``).  Past ``GROUP_COLUMNS`` (1024) the grid's y takes groups
of that many output columns, each block forming all its scores from q and
k in L2 and staging only its group's v columns (``column_groups``).  The
CPU tests walk both kernels (tests/test_torch_attention.py).

Bound (H100 SXM): per slice 4 L^2 D flops for q k^T and p v, 3 f32
operations and one exp per score, and q, k, v, out moved once: at L = 256,
D = 8 operations bound it; at L = 64 and 16, bytes.
"""
from __future__ import annotations

import ctypes

import torch

from ...utils.tracing import span
from . import _build

LAUNCHES = {"attention_fwd": 0}
ONE_PASS_MAX_DIM = 128  # the one-pass kernel's D, zero-padded to a multiple of 8
GROUP_COLUMNS = 1024  # output columns of a wide block: 16 warps' column slabs of 64
WIDE_WARPS = 16       # warps of a wide kernel block
WIDE_SLAB = 8         # n-tiles (8 output columns each) of a wide warp's column slab
# the wide kernel's (row tiles of 16 query rows, keys per staged tile), most
# rows first
WIDE_TILINGS = ((4, 32), (2, 16), (1, 8))
WARP_ROWS = 16        # query rows of one warp (the mma's m)
BLOCK_ROWS = 64       # query rows of one block: 4 warps
SMEM_LIMIT = 232448   # dynamic shared memory one Hopper block may use
TILE_BYTES = 49152    # two staged tiles' k and v of a block, where a tile allows


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def _wide_smem(rt: int, kt: int, dp: int) -> int:
    """Bytes of a wide kernel block at (RT, KT) and padded width dp: the 16
    RT q / out rows and two stages of KT k and v rows, padded to dp + 4
    floats, the WIDE_WARPS / RT partial score blocks of 16 RT x (KT + 4)
    floats, and 16 RT rescales and sums; past GROUP_COLUMNS the out rows
    and two stages of v rows of one column group (GROUP_COLUMNS + 4
    floats)."""
    br = WARP_ROWS * rt
    scores = WIDE_WARPS // rt * br * (kt + 4) + 2 * br
    if dp > GROUP_COLUMNS:
        return 4 * ((GROUP_COLUMNS + 4) * (br + 2 * kt) + scores)
    return 4 * ((dp + 4) * (br + 4 * kt) + scores)


def column_groups(D: int) -> int:
    """The wide kernel's groups of GROUP_COLUMNS output columns (the grid's
    y): one up to a padded D of GROUP_COLUMNS."""
    return -(-padded_dim(D) // GROUP_COLUMNS)


def wide_tiling(L: int, D: int):
    """The wide kernel's (RT, KT) past ``ONE_PASS_MAX_DIM``: the first of
    ``WIDE_TILINGS`` whose RT row tiles' column slabs cover the padded D
    (WIDE_WARPS / RT warps of WIDE_SLAB n-tiles each: DP RT <=
    GROUP_COLUMNS), whose 16 RT query rows L fills (RT <= ceil(L / 16)) and
    whose block fits SMEM_LIMIT; past GROUP_COLUMNS (1, 8), in column
    groups."""
    dp = padded_dim(D)
    if dp > GROUP_COLUMNS:
        return WIDE_TILINGS[-1]
    for rt, kt in WIDE_TILINGS:
        if (dp * rt <= GROUP_COLUMNS and rt <= -(-L // WARP_ROWS)
                and _wide_smem(rt, kt, dp) <= SMEM_LIMIT):
            return rt, kt
    raise ValueError(f"attention: no wide tiling for D = {D}")


def _split(n: int, parts: int):
    per = -(-n // parts)
    return [(min(c * per, n), min(c * per + per, n)) for c in range(parts)]


def wide_chunks(D: int, RT: int):
    """The wide kernel's split of the scores' contraction over a row
    tile's WIDE_WARPS / RT warps: warp c takes k-steps [d0, d1) of DP / 8,
    ceil(DP / 8 / (16 / RT)) each."""
    return _split(padded_dim(D) // 8, WIDE_WARPS // RT)


def wide_slabs(D: int, RT: int, group: int = 0):
    """The wide kernel's column slabs of column group ``group``: warp c of a
    row tile owns the p v n-tiles [e0, e1) of the group's columns (its
    first at GROUP_COLUMNS * group), ceil(n-tiles / (16 / RT)) each; up to
    GROUP_COLUMNS the same split as ``wide_chunks``."""
    cw = min(padded_dim(D) - group * GROUP_COLUMNS, GROUP_COLUMNS)
    return _split(cw // 8, WIDE_WARPS // RT)


def path(D: int) -> str:
    """The kernel that takes head width D: 'one_pass' or 'wide'."""
    return "one_pass" if D <= ONE_PASS_MAX_DIM else "wide"


def smem_bytes(L: int, D: int) -> int:
    """Dynamic shared memory of one block; the kernels compute the same.
    One pass: the block's 64 q / out rows and one (two when the slice has
    more than one tile) staged k and v tiles of its S slices, rows padded
    to DP + 4 floats.  Wide: ``_wide_smem`` at ``wide_tiling``'s (RT,
    KT)."""
    dp = padded_dim(D)
    if path(D) == "wide":
        return _wide_smem(*wide_tiling(L, D), dp)
    S, _, T = tiling(L, D)
    return 4 * (dp + 4) * (BLOCK_ROWS + (2 if L > T else 1) * 2 * S * T)


def grid(BH: int, L: int, D: int) -> int:
    """The launch's blocks along the grid's x (the wide kernel's y takes
    ``column_groups``)."""
    if path(D) == "wide":
        return BH * -(-L // (WARP_ROWS * wide_tiling(L, D)[0]))
    S, R, _ = tiling(L, D)
    return -(-BH // S) * -(-L // R)


def covers(L: int, D: int) -> bool:
    """Whether the kernels take (L, D): any L >= 1 and D >= 1 (``launch``
    also refuses a grid past the card's 2^31 - 1 x 65,535 blocks)."""
    return L >= 1 and D >= 1


def _fn(name: str):
    lib = "attention_wide" if name == "nf_attention_fwd_wide" else "attention"
    fn = getattr(_build.load(lib), name)
    if fn.argtypes is None:
        ints = 6 if lib == "attention_wide" else 7
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def launch(q, k, v):
    """The kernel on contiguous float32 (BH, L, D) q, k, v on one CUDA
    device: out (BH, L, D)."""
    with span(f"launch.attention_fwd.{path(q.shape[-1])}"):
        return _launch(q, k, v)


def _launch(q, k, v):
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
    blocks = grid(BH, L, D)
    if blocks > 2 ** 31 - 1 or column_groups(D) > 65535:
        raise ValueError(f"attention: a ({BH}, {L}, {D}) call needs {blocks} x "
                         f"{column_groups(D)} blocks, past the card's 2^31 - 1 x 65,535")
    ptrs = [t.data_ptr() for t in (q, k, v, out)]
    vec = D % 4 == 0 and all(p % 16 == 0 for p in ptrs)
    kernel = path(D)
    wide = kernel == "wide"
    with torch.cuda.device(q.device):
        err = _fn("nf_attention_fwd_wide" if wide else "nf_attention_fwd")(
            *ptrs, BH, L, D, *(wide_tiling(L, D) if wide else tiling(L, D)), int(vec),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"attention_fwd kernel failed to launch: CUDA error {err}")
    LAUNCHES["attention_fwd"] += 1
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
