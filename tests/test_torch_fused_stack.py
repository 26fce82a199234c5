"""The port's fused-stack module against nf_tpu's on the CPU.

* ``pack_stack``: every packed array and the constant log-det, atol 1e-6;
* ``fused_stack_reference`` (the kernel's plain version) against the
  Pallas kernel in interpret mode, atol 2e-5 as tests/test_pallas.py;
* the kernel's own weight layout (``kernel_weights``), walked the way the
  CUDA kernel walks it, against the plain version.
"""
import numpy as np
import pytest
import torch
from _torch_parity import close, jax_realnvp, normal, torch_realnvp

from nf_tpu.ops.pallas import fused_stack as jfs
from nf_tpu_torch.ops.cuda import fused_stack as tfs

SIZES = [(2, 8), (2, 32), (3, 8), (3, 32)]   # (D, F), layers = 4


def _both(D, F, layers=4, seed=0):
    jmodel, var = jax_realnvp(D, layers, F, seed=seed)
    tmodel = torch_realnvp(D, layers, F, var)
    jspec = jfs.extract_stack_spec(jmodel.bijector, jmodel.dims)
    tspec = tfs.extract_stack_spec(tmodel.bijector, tmodel.dims)
    return jmodel, var, jspec, tmodel, tspec


@pytest.mark.parametrize("D,F", SIZES)
def test_spec_matches(D, F):
    _, _, jspec, _, tspec = _both(D, F)
    assert jspec is not None and tspec is not None
    for field in ("n_repeats", "dim", "filters", "has_mix", "norm_kind", "halves"):
        assert getattr(tspec, field) == getattr(jspec, field), field


def test_spec_rejects_nonmatching():
    # odd repeat count -> no match, as in nf_tpu
    assert tfs.extract_stack_spec(torch_realnvp(2, 3, 8).bijector, (2,)) is None
    # a width above the kernel's 256
    assert tfs.extract_stack_spec(torch_realnvp(2, 2, 264).bijector, (2,)) is None


@pytest.mark.parametrize("D,F", SIZES)
def test_pack_stack_matches(D, F):
    jmodel, var, jspec, tmodel, tspec = _both(D, F)
    jpacked, jconst = jfs.pack_stack(jmodel.bijector, jspec, var)
    tpacked, tconst = tfs.pack_stack(tmodel.bijector, tspec)
    close(tconst, jconst, 1e-6)
    for parity in range(2):
        assert set(tpacked[parity]) == set(jpacked[parity])
        for key, arr in jpacked[parity].items():
            assert tuple(tpacked[parity][key].shape) == arr.shape, key
            close(tpacked[parity][key], arr, 1e-6)


@pytest.mark.parametrize("D,F", SIZES)
def test_reference_matches_pallas_interpret(D, F):
    jmodel, var, jspec, tmodel, tspec = _both(D, F)
    x = normal(10 + D, (64, D))
    packed, const_ld = tfs.pack_stack(tmodel.bijector, tspec)

    jz, jld = jfs.fused_stack_forward(jmodel.bijector, jspec, var, x,
                                      interpret=True)
    z, ld = tfs.fused_stack_reference(packed, const_ld, torch.from_numpy(x),
                                      "forward")
    close(z, jz, 2e-5)
    close(ld, jld, 2e-5)

    jy, jldi = jfs.fused_stack_inverse(jmodel.bijector, jspec, var,
                                       np.asarray(jz), interpret=True)
    y, ldi = tfs.fused_stack_reference(packed, const_ld, torch.tensor(
        np.asarray(jz)), "inverse")
    close(y, jy, 2e-5)
    close(ldi, jldi, 2e-5)


def _walk_kernel_layout(kw, spec, const_ld, x, inverse):
    """The CUDA kernel's loop in PyTorch, reading ``KernelWeights`` at the
    padded width: couplings c = 0..n-1 (reversed for the inverse), parity
    c % 2, t rows first and s rows from ``half`` in the head."""
    B, D = x.shape
    half = (D + 1) // 2
    x = x.clone()
    ld = torch.zeros(B)
    order = range(spec.n_repeats)
    for c in (reversed(order) if inverse else order):
        p = c % 2
        n_out, n_in = (D + 1 - p) // 2, (D + p) // 2
        pre = (kw.prei if inverse else kw.pre)[c]
        if not inverse:
            x = (x - pre[:, 0]) * pre[:, 1]
        V = kw.vec[c]
        h = x[:, 1 - p::2][:, :n_in] @ kw.w0t[c, :n_in] + V[0]
        for r in range(2):
            o = 1 + 6 * r
            u = torch.relu(h * V[o] + V[o + 1]) @ kw.wrt[c, 2 * r] + V[o + 2]
            u = torch.relu(u * V[o + 3] + V[o + 4]) @ kw.wrt[c, 2 * r + 1] + V[o + 5]
            h = h + u
        raw = torch.relu(h * V[13] + V[14]) @ kw.wh[c].T + kw.bh[c]
        t, raw_s = raw[:, :n_out], raw[:, half:half + n_out]
        s = torch.tanh(raw_s) * kw.gb[c, 0] + kw.gb[c, 1]
        rows = list(range(p, D, 2))
        if inverse:
            x[:, rows] = (x[:, rows] - t) * torch.exp(-s)
            ld = ld - s.sum(1)
            x = x * pre[:, 1] + pre[:, 0]
        else:
            x[:, rows] = x[:, rows] * torch.exp(s) + t
            ld = ld + s.sum(1)
    return x, ld + (-const_ld if inverse else const_ld)


@pytest.mark.parametrize("D,F", [(2, 8), (3, 20), (5, 32)])
def test_kernel_layout_matches_reference(D, F):
    tmodel = torch_realnvp(D, 4, F, jax_realnvp(D, 4, F, seed=1)[1])
    spec = tfs.extract_stack_spec(tmodel.bijector, tmodel.dims)
    packed, const_ld = tfs.pack_stack(tmodel.bijector, spec)
    kw = tfs.kernel_weights(spec, packed)
    assert kw.fp == tfs.padded_width(F) and kw.fp >= F
    x = torch.from_numpy(normal(20 + D, (33, D)))
    for direction in ("forward", "inverse"):
        want = tfs.fused_stack_reference(packed, const_ld, x, direction)
        got = _walk_kernel_layout(kw, spec, const_ld, x, direction == "inverse")
        close(got[0], want[0], 2e-5)
        close(got[1], want[1], 2e-5)


def test_smem_budget_covers_headline_and_wide_stacks():
    # the headline stack and the widest accepted conditioner fit one block
    for fp, (S, _) in tfs.TILES.items():
        assert tfs.smem_bytes(fp, S, 3) <= tfs.SMEM_LIMIT
    fp = tfs.padded_width(32)
    assert tfs.smem_bytes(fp, tfs.TILES[fp][0], 2) < 48 * 1024


def test_wrapper_takes_plain_version_on_cpu():
    tmodel = torch_realnvp(2, 4, 8, jax_realnvp(2, 4, 8)[1])
    spec = tfs.extract_stack_spec(tmodel.bijector, tmodel.dims)
    stack = tfs.PackedStack(spec, *tfs.pack_stack(tmodel.bijector, spec))
    assert stack.kernel is None
    x = torch.from_numpy(normal(3, (10, 2)))
    before = dict(tfs.LAUNCHES)
    z, ld = tfs.fused_stack(stack, x, "forward")
    assert tfs.LAUNCHES == before
    want = tfs.fused_stack_reference(stack.packed, stack.const_ld, x, "forward")
    close(z, want[0], 0.0)
    close(ld, want[1], 0.0)
    with pytest.raises(ValueError, match="direction"):
        tfs.fused_stack(stack, x, "sideways")
