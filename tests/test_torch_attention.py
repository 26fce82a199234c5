"""The port's attention (``ops/attention.py``, ``ops/cuda/attention.py``)
against nf_tpu's, on the CPU.

* ``attention_reference`` against nf_tpu's ``attention_reference`` and
  ``attention_pallas`` in interpret mode, at (8, 64, 8) and ragged
  lengths: atol / rtol 1e-5 (f32 sums in another order, as
  tests/test_pallas.py holds the Pallas kernel);
* the one-token identity, the role permutation against the reference's
  legacy einsum, and the gradient against nf_tpu's custom VJP (1e-5);
* the kernel's tiling (``tiling``) walked in PyTorch the way
  csrc/attention.cu walks it (every row owned by one warp; one pass over
  the key tiles with an online max and exp2 of prescaled scores, both
  products in 3xTF32 emulated bit by bit (q and v rounded to TF32, k and p
  truncated, the small parts truncated as the tensor core reads them); the
  division last): atol / rtol 1e-5 against the
  plain version, at D = 2 to 128 and L = 2 to 1500; past D = 128 the
  wide kernel walked the same way (``wide_tiling``'s row tiles, the
  partial scores per chunk of D summed in chunk order, the softmax
  threads' shares of the running sum, p v per column slab of
  ``wide_chunks``; D = 129 to 1000), every head width 129 to 1024 planned
  within one block, and the plain version at (16, 192) against nf_tpu's;
* the wrapper: a CPU tensor takes the plain version with no launch
  counted, and the kernel's own entry refuses a CPU tensor.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import close, normal

from nf_tpu_torch.ops import attention as tattn
from nf_tpu_torch.ops.cuda import attention as cattn

# the package exports a function of this name: take the module itself
jattn = importlib.import_module("nf_tpu.ops.pallas.attention")
TOL = dict(atol=1e-5, rtol=1e-5)


def _qkv(seed, shape):
    return [normal(seed + i, shape) for i in range(3)]


@pytest.mark.parametrize("shape", [(8, 64, 8), (6, 49, 8), (5, 37, 4), (3, 100, 32)])
def test_reference_matches_nf_tpu_and_pallas_interpret(shape):
    q, k, v = _qkv(sum(shape), shape)
    got = tattn.attention_reference(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jattn.attention_reference(q, k, v)),
                               **TOL)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jattn.attention_pallas(q, k, v, interpret=True)),
                               **TOL)


def test_one_token_is_the_identity_on_the_value():
    q, k, v = map(torch.from_numpy, _qkv(1, (7, 1, 8)))
    assert tattn.attention(q, k, v) is v
    close(tattn.attention(q, k, v), np.asarray(jattn.attention(q.numpy(), k.numpy(),
                                                               v.numpy())), 0.0)


def test_role_permutation_matches_legacy_einsum():
    """attention(q=K, k=V, v=Q) == the reference's softmax(V^T K) @ Q."""
    B, h, L, D = 2, 4, 16, 2
    V, K, Q = (normal(10 + i, (B, h, L, D)) for i in range(3))
    scores = np.einsum("bhld,bhmd->bhlm", V, K) / np.sqrt(D)
    W = np.asarray(jax.nn.softmax(scores, axis=2))
    legacy = np.einsum("bhld,bhlm->bhmd", Q, W)
    got = tattn.attention(*(torch.from_numpy(a.reshape(B * h, L, D)) for a in (K, V, Q)))
    close(got.reshape(B, h, L, D), legacy, 1e-5, 1e-5)


def test_gradient_matches_nf_tpu():
    q, k, v = _qkv(20, (3, 24, 8))
    cot = normal(23, (3, 24, 8))
    jg = jax.grad(lambda a, b, c: jnp.sum(jattn.attention(a, b, c) * cot),
                  argnums=(0, 1, 2))(q, k, v)
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    (tattn.attention(*leaves) * torch.from_numpy(cot)).sum().backward()
    for t, j in zip(leaves, jg):
        close(t.grad, j, 1e-5, 1e-5)


def _tf32(x):
    """Round to TF32 as cvt.rna.tf32.f32 does: the 13 low mantissa bits
    cleared, to nearest with ties away from zero, on the int32 view."""
    return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)


def _trunc_tf32(x):
    """What a tensor core reads of an f32 operand: its top 19 bits."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _mm3(a, b, round_a):
    """a @ b in 3xTF32: big = tf32(x), rounded on the side ``round_a``
    names (a if true, else b) and truncated on the other, small = x - big
    as the tensor core reads it (truncated to TF32); the small products
    first, then big @ big, summed in f32."""
    ab = _tf32(a) if round_a else _trunc_tf32(a)
    bb = _trunc_tf32(b) if round_a else _tf32(b)
    as_, bs = _trunc_tf32(a - ab), _trunc_tf32(b - bb)
    return ab @ bs + as_ @ bb + ab @ bb


def _walk_kernel(q, k, v):
    """csrc/attention.cu's walk in PyTorch: the grid of ``tiling``'s blocks
    (each (slice, row) owned by exactly one warp), q prescaled by log2(e) /
    sqrt(D), then per staged tile of T keys and per chunk of ``key_chunk``
    keys in it the 3xTF32 scores, the chunk's row maximum, one rescale of
    the running sum and accumulators, exp2(s - m) and the 3xTF32 p v
    product; the division last."""
    BH, L, D = q.shape
    S, R, T = cattn.tiling(L, D)
    owner = torch.zeros(BH, L, dtype=torch.int64)
    row_blocks = -(-L // R)
    for b in range(-(-BH // S) * row_blocks):   # a slice's row blocks adjacent
        for w in range(cattn.BLOCK_ROWS // cattn.WARP_ROWS):
            s = b // row_blocks * S + w // (R // cattn.WARP_ROWS)
            r0 = b % row_blocks * R + w % (R // cattn.WARP_ROWS) * cattn.WARP_ROWS
            if s < BH and r0 < L:
                owner[s, r0:r0 + cattn.WARP_ROWS] += 1
    assert bool((owner == 1).all())
    # q prescaled by log2(e) / sqrt(D) as it is staged; the exps are exp2
    q = q * torch.tensor(np.log2(np.e) / np.sqrt(D), dtype=torch.float32)
    m = torch.full((BH, L, 1), -float("inf"))
    l = torch.zeros(BH, L, 1)
    acc = torch.zeros_like(q)
    kc = cattn.key_chunk(cattn.padded_dim(D))
    for j0, c0 in ((j0, c0) for j0 in range(0, L, T) for c0 in range(j0, min(j0 + T, L), kc)):
        kt, vt = k[:, c0:c0 + kc], v[:, c0:c0 + kc]
        s = _mm3(q, kt.transpose(1, 2), round_a=True)      # q rounded, k truncated
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        m = m_new
        p = torch.exp2(s - m)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + _mm3(p, vt, round_a=False)     # p truncated, v rounded
    return acc / l


WALK_SHAPES = [(9, 49, 8), (17, 16, 8), (5, 64, 8), (2, 256, 8), (3, 300, 64), (4, 100, 32),
               (3, 20, 2), (6, 256, 12), (2, 100, 128), (7, 2, 8), (2, 1500, 8)]


@pytest.mark.parametrize("shape", WALK_SHAPES)
def test_kernel_tiling_walk_matches_reference(shape):
    BH, L, D = shape
    S, R, T = cattn.tiling(L, D)
    dp = cattn.padded_dim(D)
    assert S * R == cattn.BLOCK_ROWS and R % cattn.WARP_ROWS == 0
    assert T % 8 == 0 and (T >= L or T % cattn.key_chunk(dp) == 0)
    assert cattn.covers(L, D) and cattn.smem_bytes(L, D) <= cattn.SMEM_LIMIT
    q, k, v = map(torch.from_numpy, _qkv(BH + L, shape))
    close(_walk_kernel(q, k, v), tattn.attention_reference(q, k, v), **TOL)


def test_tf32_split_rounds_to_nearest():
    """The split's rounding: big to nearest, ties away from zero; big and
    small as the tensor core reads it within 2^-22 of x."""
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12, 3.0])
    assert _tf32(x).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0, 3.0]
    y = torch.from_numpy(normal(4, (1000,)))
    big = _tf32(y)
    assert bool(((y - big - _trunc_tf32(y - big)).abs() <= 2.0 ** -22 * y.abs()).all())


def test_main_path_tilings():
    """flowpp-img32x1's three lengths (D = 8): 64 query rows a block and the
    whole slice staged at once at L = 256 (walked in 4 chunks of 64 keys)
    and L = 64, four slices of one warp at L = 16; D = 12 (base_filters =
    48) stages 128 keys at a time, double-buffered, and D = 128 32."""
    assert {L: cattn.tiling(L, 8) for L in (256, 64, 16)} == {
        256: (1, 64, 256), 64: (1, 64, 64), 16: (4, 16, 16)}
    assert cattn.tiling(256, 12) == (1, 64, 128) and cattn.padded_dim(12) == 16
    assert cattn.tiling(64, 128) == (1, 64, 32) and cattn.tiling(20, 8) == (2, 32, 24)
    assert {L: cattn.smem_bytes(L, 8) for L in (256, 64, 16)} == {
        256: 4 * 12 * (64 + 2 * 256), 64: 4 * 12 * (64 + 2 * 64), 16: 4 * 12 * (64 + 2 * 64)}
    # past D = 128 the wide kernel covers the shape: a plan that fits one
    # block (16 rows of one slice at L = 16), and a CPU tensor counts no
    # launch; row 3w's shapes take 64 and 32 rows a block
    assert cattn.covers(16, 129) and cattn.path(129) == "wide"
    assert cattn.wide_tiling(16, 129) == (1, 8) and cattn.grid(4, 16, 129) == 4
    assert cattn.smem_bytes(16, 129) == 4 * (140 * (16 + 32) + 16 * 16 * 12 + 32) \
        <= cattn.SMEM_LIMIT
    assert cattn.wide_tiling(256, 192) == (4, 32) and cattn.grid(64, 256, 192) == 256
    assert cattn.wide_tiling(64, 512) == (2, 16) and cattn.grid(64, 64, 512) == 128
    assert cattn.wide_chunks(192, 4) == [(0, 6), (6, 12), (12, 18), (18, 24)]
    # four row tiles fit one block up to DP = 248; D = 256 takes two
    assert cattn.wide_tiling(256, 248) == (4, 32) and cattn.wide_tiling(256, 249) == (2, 16)
    # past 1,024 columns (GatedAttn past base_filters 4,096) column groups
    assert cattn.covers(16, cattn.GROUP_COLUMNS + 1) and cattn.wide_tiling(256, 2048) == (1, 8)
    assert cattn.column_groups(1024) == 1 and cattn.column_groups(1025) == 2
    assert cattn.grid(4, 256, 2048) == 64 and cattn.column_groups(2048) == 2
    q, k, v = map(torch.from_numpy, _qkv(9, (4, 16, 129)))
    before = dict(cattn.LAUNCHES)
    close(tattn.attention(q, k, v), tattn.attention_reference(q, k, v), 0.0)
    assert cattn.LAUNCHES == before and not cattn.covers(0, 8)


def _butterfly_sum(x):
    """Each lane's value after xor shuffles over the last axis (lanes 1, 2,
    4, ... apart), as the kernel sums a row's shares: lane 0's."""
    lanes = torch.arange(x.shape[-1])
    step = 1
    while step < x.shape[-1]:
        x = x + x[..., lanes ^ step]
        step *= 2
    return x[..., 0]


def _walk_wide_kernel(q, k, v):
    """csrc/attention_wide.cu's walk in PyTorch (D past 128): ``grid``'s
    blocks of 16 RT query rows of one slice (``wide_tiling``) by
    ``column_groups`` of output columns, each (row, output column) owned by
    exactly one warp's column slab (``wide_slabs``); q prescaled by
    log2(e) / sqrt(D); per staged tile of KT keys each warp's partial
    3xTF32 scores over its chunk of D (``wide_chunks``, all of D in every
    group), summed in chunk order, the tile's row maximum, one rescale,
    exp2(s - m), each of the row's G softmax threads' share of the running
    sum (KT / G keys), and the 3xTF32 p v product per column slab; the
    shares summed by xor shuffles and the division last."""
    BH, L, D = q.shape
    RT, KT = cattn.wide_tiling(L, D)
    BR = cattn.WARP_ROWS * RT
    dp = cattn.padded_dim(D)
    chunks = cattn.wide_chunks(D, RT)
    groups = cattn.column_groups(D)
    slabs = [(g * cattn.GROUP_COLUMNS // 8 + e0, g * cattn.GROUP_COLUMNS // 8 + e1)
             for g in range(groups) for e0, e1 in cattn.wide_slabs(D, RT, g)]
    row_blocks = -(-L // BR)
    assert cattn.grid(BH, L, D) == BH * row_blocks
    assert chunks[0][0] == 0 and chunks[-1][1] == dp // 8
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    owner = torch.zeros(BH, L, dp, dtype=torch.int64)
    for b in range(BH * row_blocks):
        s, row0 = b // row_blocks, b % row_blocks * BR
        for g in range(groups):
            for w in range(cattn.WIDE_WARPS):
                e0, e1 = slabs[g * (cattn.WIDE_WARPS // RT) + w // RT]
                assert e1 - e0 <= cattn.WIDE_SLAB
                r0 = row0 + w % RT * cattn.WARP_ROWS
                owner[s, r0:r0 + cattn.WARP_ROWS, 8 * e0:8 * e1] += 1
    assert bool((owner == 1).all())
    pad = (0, dp - D)
    qs = torch.nn.functional.pad(q, pad) * torch.tensor(np.log2(np.e) / np.sqrt(D),
                                                        dtype=torch.float32)
    kp, vp = (torch.nn.functional.pad(t, pad) for t in (k, v))
    G = min(cattn.WIDE_WARPS * 32 // BR, KT)
    kpt = KT // G
    m = torch.full((BH, L, 1), -float("inf"))
    shares = torch.zeros(BH, L, G)
    acc = torch.zeros(BH, L, dp)
    for j0 in range(0, L, KT):
        kt, vt = kp[:, j0:j0 + KT], vp[:, j0:j0 + KT]
        s = sum(_mm3(qs[..., 8 * d0:8 * d1], kt[..., 8 * d0:8 * d1].transpose(1, 2),
                     round_a=True) for d0, d1 in chunks)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        m = m_new
        p = torch.exp2(s - m)
        shares = shares * alpha + torch.stack(
            [p[..., i * kpt:(i + 1) * kpt].sum(-1) for i in range(G)], -1)
        for e0, e1 in slabs:
            cols = slice(8 * e0, 8 * e1)
            acc[..., cols] = acc[..., cols] * alpha + _mm3(p, vt[..., cols], round_a=False)
    return (acc / _butterfly_sum(shares)[..., None])[..., :D]


@pytest.mark.parametrize("shape", [(5, 16, 192), (3, 20, 129), (2, 70, 256), (2, 33, 300),
                                   (2, 20, 1000), (2, 19, 1030), (1, 12, 2100)])
def test_wide_kernel_walk_matches_reference(shape):
    """Past D = 128: the wide kernel's walk against the plain version,
    atol / rtol 1e-5, at each of its tilings (RT = 1, 2, 4), ragged tiles,
    chunks and padded D, and past 1,024 in two and three column groups
    (the last ragged)."""
    BH, L, D = shape
    assert cattn.path(D) == "wide"
    assert cattn.smem_bytes(L, D) <= cattn.SMEM_LIMIT
    q, k, v = map(torch.from_numpy, _qkv(BH + D, shape))
    close(_walk_wide_kernel(q, k, v), tattn.attention_reference(q, k, v), **TOL)


def test_wide_reference_matches_nf_tpu_and_pallas_interpret():
    """(L, D) = (16, 192): the port's plain version against nf_tpu's
    reference and its Pallas kernel in interpret mode (which takes any
    D), atol / rtol 1e-5 (a module)."""
    q, k, v = _qkv(192, (4, 16, 192))
    got = tattn.attention(*map(torch.from_numpy, (q, k, v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(jattn.attention_reference(q, k, v)),
                               **TOL)
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(jattn.attention_pallas(q, k, v, interpret=True)),
                               **TOL)


@pytest.mark.parametrize("D", [129, 192, 256, 512])
def test_every_head_width_has_a_plan_within_one_block(D):
    """Every head width past 128 that GatedAttn gives (base_filters / 4) has
    a plan at every length: one block's shared memory within 232,448
    bytes, column slabs of at most WIDE_SLAB n-tiles that cover the padded
    D, and a grid within the card's limits."""
    for L in (1, 2, 16, 17, 33, 64, 256, 1500):
        assert cattn.covers(L, D) and cattn.path(D) == "wide"
        assert cattn.smem_bytes(L, D) <= cattn.SMEM_LIMIT == 232448
        RT, KT = cattn.wide_tiling(L, D)
        assert (RT, KT) in cattn.WIDE_TILINGS and RT <= -(-L // 16)
        chunks = cattn.wide_chunks(D, RT)
        assert chunks[0][0] == 0 and chunks[-1][1] == cattn.padded_dim(D) // 8
        assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
        assert max(d1 - d0 for d0, d1 in chunks) <= cattn.WIDE_SLAB
        assert cattn.grid(4096, L, D) < 2 ** 31


def test_every_width_from_129_to_the_widest_has_a_plan():
    """Every D from 129 to 2,100, at the lengths that pick each tiling,
    and a few far wider fit one block, with column slabs of at most
    WIDE_SLAB n-tiles that cover each group; the blocks' shared memory
    stops growing past GROUP_COLUMNS, so no D is refused."""
    for D in range(129, 2101):
        for L in (16, 32, 256):
            assert cattn.smem_bytes(L, D) <= cattn.SMEM_LIMIT, (L, D)
    assert {cattn.wide_tiling(256, D)[0] for D in (129, 256, 257, 512, 513, 1024)} == {4, 2, 1}
    for D in (1025, 4096, 65536, 10 ** 6):
        assert cattn.covers(1, D) and cattn.wide_tiling(1, D) == (1, 8)
        assert cattn.smem_bytes(1, D) == cattn.smem_bytes(1, 1025) <= cattn.SMEM_LIMIT
        groups = cattn.column_groups(D)
        cols = sum(8 * (e1 - e0) for g in range(groups) for e0, e1 in cattn.wide_slabs(D, 1, g))
        assert cols == cattn.padded_dim(D) and groups <= 65535
        assert max(e1 - e0 for e0, e1 in cattn.wide_slabs(D, 1, groups - 1)) <= cattn.WIDE_SLAB


def test_cpu_tensors_take_the_plain_version():
    q, k, v = map(torch.from_numpy, _qkv(30, (4, 32, 8)))
    before = dict(cattn.LAUNCHES)
    close(tattn.attention(q, k, v), tattn.attention_reference(q, k, v), 0.0)
    assert cattn.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        cattn.launch(q, k, v)
