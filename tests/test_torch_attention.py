"""The port's attention (``ops/attention.py``, ``ops/cuda/attention.py``)
against nf_tpu's, on the CPU.

* ``attention_reference`` against nf_tpu's ``attention_reference`` and
  ``attention_pallas`` in interpret mode, at (8, 64, 8) and ragged
  lengths: atol / rtol 1e-5 (f32 sums in another order, as
  tests/test_pallas.py holds the Pallas kernel);
* the one-token identity, the role permutation against the reference's
  legacy einsum, and the gradient against nf_tpu's custom VJP (1e-5);
* the kernel's tiling (``tiling``) walked block by block in PyTorch the way
  csrc/attention.cu walks it (two passes over staged key tiles, the
  division last): atol / rtol 1e-5 against the plain version;
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


def _walk_kernel(q, k, v):
    """csrc/attention.cu's loop in PyTorch: blocks of S slices x R rows,
    keys staged T at a time, pass one the row maximum, pass two the
    exp-weighted sums, the division last."""
    BH, L, D = q.shape
    S, R, T = cattn.tiling(L, D)
    out = torch.full_like(q, float("nan"))
    scale = 1.0 / np.sqrt(D)
    for bx in range(-(-BH // S)):
        sl = slice(bx * S, min(BH, bx * S + S))
        for by in range(-(-L // R)):
            rows = slice(by * R, min(L, by * R + R))
            qb = q[sl, rows]
            m = torch.full(qb.shape[:2], -float("inf"))
            for j0 in range(0, L, T):
                kt = k[sl, j0:j0 + T]
                m = torch.maximum(m, (qb @ kt.transpose(1, 2) * scale).amax(-1))
            acc, l = torch.zeros_like(qb), torch.zeros(qb.shape[:2])
            for j0 in range(0, L, T):
                e = torch.exp(qb @ k[sl, j0:j0 + T].transpose(1, 2) * scale - m[..., None])
                l = l + e.sum(-1)
                acc = acc + e @ v[sl, j0:j0 + T]
            out[sl, rows] = acc / l[..., None]
    return out


@pytest.mark.parametrize("shape", [(9, 49, 8), (17, 16, 8), (5, 64, 8), (2, 256, 8),
                                   (3, 300, 64), (4, 100, 32), (3, 20, 2)])
def test_kernel_tiling_walk_matches_reference(shape):
    BH, L, D = shape
    S, R, T = cattn.tiling(L, D)
    assert S * R <= cattn.ROWS_PER_SLICE and 2 * S * T * D <= cattn.TILE_FLOATS
    assert S * R >= min(cattn.MIN_THREADS, L) and 1 <= T <= L
    q, k, v = map(torch.from_numpy, _qkv(BH + L, shape))
    close(_walk_kernel(q, k, v), tattn.attention_reference(q, k, v), **TOL)


def test_main_path_tilings():
    """flowpp-img32x1's three lengths (D = 8): one tile of keys each, the
    whole slice staged; 256, 128 and 128 threads per block."""
    assert {L: cattn.tiling(L, 8) for L in (256, 64, 16)} == {
        256: (1, 256, 256), 64: (2, 64, 64), 16: (8, 16, 16)}


def test_cpu_tensors_take_the_plain_version():
    q, k, v = map(torch.from_numpy, _qkv(30, (4, 32, 8)))
    before = dict(cattn.LAUNCHES)
    close(tattn.attention(q, k, v), tattn.attention_reference(q, k, v), 0.0)
    assert cattn.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensor"):
        cattn.launch(q, k, v)
