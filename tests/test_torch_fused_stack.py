"""The port's fused-stack module against nf_tpu's on the CPU.

* ``pack_stack``: every packed array and the constant log-det, atol 1e-6;
* ``fused_stack_reference`` (the kernel's plain version) against the
  Pallas kernel in interpret mode, atol 2e-5 as tests/test_pallas.py;
* the tensor-core kernel's weight layout (``kernel_weights``: headers and
  B fragments with permuted input rows), walked the way the CUDA kernel
  walks it, 3xTF32 split and quad reductions included, against the plain
  version at 2e-5, RealNVP and Glow; the FFMA kernel's layout the same
  way at the shapes it keeps (F = 128, D = 9);
* the shape dispatch between the two kernels and their shared-memory
  budgets;
* the matcher at shapes past the FFMA block's shared memory, against
  nf_tpu's, and the program there against nf_tpu's EvalProgram (1e-4),
  up to D = 400 (the cluster kernel's shapes); the cluster kernel's
  layout walked the way csrc/fused_stack_wide.cu walks it (the sample
  tiles of a cluster, the members' x rows, the in-projection partials
  summed in member order, the conditioner on each member's samples, the
  head and log-det shares per member's rows, W^T streamed in chunks of
  16 rows) at D = 63 and 400, RealNVP and Glow, against the plain version
  (2e-5) and nf_tpu's EvalProgram (1e-4, z also rtol 1e-4); every
  (D, F) of a grid up to D = 1024, F = 256 planned within one block's
  shared memory and a cluster of 4.
"""
import numpy as np
import pytest
import torch
from _torch_parity import close, jax_model, jax_realnvp, normal, torch_model, torch_realnvp

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


def _trunc(x):
    """x as the tensor core reads an f32 operand: 13 low mantissa bits
    dropped."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _decode_layer(kw, c, layer):
    """Layer ``layer`` of coupling c as the kernel multiplies it, from its B
    fragments: (big, small) (fp, fp) [k-position, out], small as the tensor
    core reads it."""
    lay = kw.layout
    fp, T = lay.fp, lay.fp // 8
    f = kw.frag[c, layer].view(T, T, 32, 4)
    big, small = f[..., :2], f[..., 2:]
    ks = torch.arange(T)[:, None, None, None]
    nt = torch.arange(T)[None, :, None, None]
    lane = torch.arange(32)[None, None, :, None]
    r = torch.arange(2)[None, None, None, :]
    shape = (T, T, 32, 2)
    kpos = (8 * ks + lane % 4 + 4 * r).expand(shape)
    out = (8 * nt + lane // 4).expand(shape)
    Bb, Bs = torch.zeros(fp, fp), torch.zeros(fp, fp)
    Bb[kpos, out] = big
    Bs[kpos, out] = _trunc(small)
    return Bb, Bs


def _mma_3xtf32(u, Bb, Bs, perm):
    """u (B, fp) in feature order times the decoded layer, as the kernel
    forms it: A = u at the permuted positions, truncated to big + small per
    k-step of 8, the small products first, each m16n8k8 product added to
    the f32 accumulator."""
    a = u[:, perm]
    ab = _trunc(a)
    asm = _trunc(a - ab)
    acc = torch.zeros(u.shape[0], Bb.shape[1])
    for k0 in range(0, a.shape[1], 8):
        k = slice(k0, k0 + 8)
        for lhs, rhs in ((ab, Bs), (asm, Bb), (ab, Bb)):
            acc = acc + (lhs[:, k].double() @ rhs[k].double()).float()
    return acc


def _head(u, wh):
    """raw = u wh^T in the kernel's order: lane t's partial dot product
    over its features 8 j + 2 t, 8 j + 2 t + 1 (j ascending), then the
    quad's sum (p0 + p1) + (p2 + p3)."""
    fp = u.shape[1]
    parts = []
    for t in range(4):
        p = torch.zeros(u.shape[0], wh.shape[0])
        for j in range(fp // 8):
            for e in range(2):
                f = 8 * j + 2 * t + e
                p = p + u[:, f:f + 1] * wh[:, f]
        parts.append(p)
    return (parts[0] + parts[1]) + (parts[2] + parts[3])


def _walk_kernel_layout(kw, spec, const_ld, x, inverse):
    """The tensor-core kernel's walk in PyTorch, reading only
    ``MmaWeights``: this direction's header per coupling at the layout's
    offsets, the four layers decoded from their B fragments and multiplied
    in 3xTF32, the head summed over the quad; couplings c = 0..n-1
    (reversed for the inverse), parity c % 2, x padded to dp."""
    lay = kw.layout
    fp, dp, half = lay.fp, lay.dp, lay.half
    n = spec.n_repeats
    B, D = x.shape
    perm = tfs.input_permutation(fp)
    xs = torch.zeros(B, dp)
    xs[:, :D] = x
    ld = torch.zeros(B)
    hdr = kw.hdr[int(inverse)]
    for s in range(n):
        c = n - 1 - s if inverse else s
        P = c % 2
        n_out = (D + 1 - P) // 2
        h = hdr[c]
        vec = h[:lay.w0].view(15, fp)
        w0 = h[lay.w0:lay.wh].view(half, fp)
        wh = h[lay.wh:lay.bh].view(2 * half, fp)
        bh = h[lay.bh:lay.gb]
        gain, cbias = h[lay.gb], h[lay.gb + 1]
        pre = h[lay.pre:lay.mix].view(dp, 2)
        mix = h[lay.mix:lay.mix + dp * dp].view(dp, dp)
        if not inverse:
            xs = (xs - pre[:, 0]) * pre[:, 1]
            if spec.has_mix:
                xs = xs @ mix.T
        hh = vec[0].expand(B, fp)
        for k in range(half):
            hh = hh + xs[:, 2 * k + 1 - P, None] * w0[k]
        for r in range(2):
            o = 1 + 6 * r
            u = torch.relu(hh * vec[o] + vec[o + 1])
            acc = _mma_3xtf32(u, *_decode_layer(kw, c, 2 * r), perm) + vec[o + 2]
            u = torch.relu(acc * vec[o + 3] + vec[o + 4])
            acc = _mma_3xtf32(u, *_decode_layer(kw, c, 2 * r + 1), perm) + vec[o + 5]
            hh = hh + acc
        raw = _head(torch.relu(hh * vec[13] + vec[14]), wh) + bh
        xs = xs.clone()
        lsum = torch.zeros(B)
        for k in range(n_out):
            sv = torch.tanh(raw[:, half + k]) * gain + cbias
            row = 2 * k + P
            if inverse:
                xs[:, row] = (xs[:, row] - raw[:, k]) * torch.exp(-sv)
            else:
                xs[:, row] = xs[:, row] * torch.exp(sv) + raw[:, k]
            lsum = lsum + sv
        ld = ld - lsum if inverse else ld + lsum
        if inverse:
            if spec.has_mix:
                xs = xs @ mix.T
            xs = xs * pre[:, 1] + pre[:, 0]
    assert torch.all(xs[:, D:] == 0)     # padded dimensions stay exactly 0
    return xs[:, :D], ld + (-const_ld if inverse else const_ld)


def _walk_ffma_layout(kw, spec, const_ld, x, inverse):
    """The FFMA kernel's loop in PyTorch, reading ``FfmaWeights`` at the
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
            if kw.mix is not None:
                x = x @ kw.mix[c].T
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
            if kw.mix is not None:
                x = x @ kw.mixi[c].T
            x = x * pre[:, 1] + pre[:, 0]
        else:
            x[:, rows] = x[:, rows] * torch.exp(s) + t
            ld = ld + s.sum(1)
    return x, ld + (-const_ld if inverse else const_ld)


def _walk_cluster_layout(kw, spec, const_ld, x, inverse):
    """csrc/fused_stack_wide.cu's walk in PyTorch, reading ``FfmaWeights``
    on the cluster paths (the x tile in shared or in device memory, the
    same arithmetic): clusters of S samples (``kw.tile``), member m of a
    cluster owning x rows [m Dc, m Dc + Dc) (``member_rows``) and the
    conditioner's samples [m S / C, (m + 1) S / C) (each (sample, row) and
    each sample once); per coupling the in-projection partial of each
    member's z1 rows, summed in member order, then b0; the conditioner;
    each member's z0 rows' t and s, its share of the log-det summed in row
    order and the shares summed in member order at the end; the mix from
    W^T (``cluster_mix``: zero past D) in chunks of MIX_ROWS rows (a pass
    over W^T per TILE_ITEMS x CLUSTER_THREADS tiles of 4 rows x 4 samples:
    each tile's sum in the same chunk order), the inverse's un-affine in
    its epilogue."""
    B, D = x.shape
    S, C = kw.tile
    assert C == tfs.CLUSTER and S % C == 0 and kw.path.startswith("ffma_cluster")
    dc, sm = tfs.member_rows(D), S // C
    half = (D + 1) // 2
    clusters = -(-B // S)
    members = [range(m * dc, min(D, m * dc + dc)) for m in range(C)]
    owner = torch.zeros(clusters * S, D, dtype=torch.int64)
    cond = torch.zeros(clusters * S, dtype=torch.int64)
    for cl in range(clusters):
        for m, rows in enumerate(members):
            owner[cl * S:(cl + 1) * S, list(rows)] += 1
            cond[cl * S + m * sm:cl * S + (m + 1) * sm] += 1
    assert bool((owner == 1).all() and (cond == 1).all())
    if kw.mix is not None:
        assert kw.mix.shape == (spec.n_repeats, D, C * dc)
        assert bool((kw.mix[..., D:] == 0).all() and (kw.mixi[..., D:] == 0).all())
    xs = x.clone()
    shares = torch.zeros(C, B)

    def mix(mt, pre=None):
        out = torch.zeros(B, C * dc)
        for k0 in range(0, D, tfs.MIX_ROWS):
            out = out + xs[:, k0:k0 + tfs.MIX_ROWS] @ mt[k0:k0 + tfs.MIX_ROWS]
        out = out[:, :D]
        return out if pre is None else out * pre[:, 1] + pre[:, 0]

    order = range(spec.n_repeats)
    for c in (reversed(order) if inverse else order):
        p = c % 2
        pre = (kw.prei if inverse else kw.pre)[c]
        if not inverse:
            xs = (xs - pre[:, 0]) * pre[:, 1]
            if kw.mix is not None:
                xs = mix(kw.mix[c])
        V = kw.vec[c]
        parts = []
        for rows in members:
            part = torch.zeros(B, kw.fp)
            for g in rows:
                if g % 2 == 1 - p:
                    part = part + xs[:, g:g + 1] * kw.w0t[c, g >> 1]
            parts.append(part)
        h = sum(parts) + V[0]
        for r in range(2):
            o = 1 + 6 * r
            u = torch.relu(h * V[o] + V[o + 1]) @ kw.wrt[c, 2 * r] + V[o + 2]
            u = torch.relu(u * V[o + 3] + V[o + 4]) @ kw.wrt[c, 2 * r + 1] + V[o + 5]
            h = h + u
        a = torch.relu(h * V[13] + V[14])
        xs = xs.clone()
        for m, rows in enumerate(members):
            share = torch.zeros(B)
            for g in rows:
                if g % 2 != p:
                    continue
                i = g >> 1
                t = a @ kw.wh[c, i] + kw.bh[c, i]
                sv = torch.tanh(a @ kw.wh[c, half + i] + kw.bh[c, half + i]) * kw.gb[c, 0] \
                    + kw.gb[c, 1]
                xs[:, g] = (xs[:, g] - t) * torch.exp(-sv) if inverse \
                    else xs[:, g] * torch.exp(sv) + t
                share = share + sv
            shares[m] = shares[m] + (-share if inverse else share)
        if inverse:
            xs = mix(kw.mixi[c], pre) if kw.mix is not None else xs * pre[:, 1] + pre[:, 0]
    return xs, sum(shares[m] for m in range(C)) + (-const_ld if inverse else const_ld)


def _packed(name, D, F):
    tmodel = torch_model(name, D, 4, F, jax_model(name, D, 4, F, seed=1)[1])
    spec = tfs.extract_stack_spec(tmodel.bijector, tmodel.dims)
    assert spec is not None and spec.has_mix == (name == "glow")
    return (spec, *tfs.pack_stack(tmodel.bijector, spec))


@pytest.mark.parametrize("name", ["realnvp", "glow"])
@pytest.mark.parametrize("D,F", [(2, 8), (3, 20), (5, 32), (2, 64)])
def test_kernel_layout_matches_reference(name, D, F):
    spec, packed, const_ld = _packed(name, D, F)
    kw = tfs.kernel_weights(spec, packed)
    assert isinstance(kw, tfs.MmaWeights)
    assert kw.fp == tfs.padded_width(F) and kw.fp >= F and kw.layout.dp >= D
    assert kw.hdr.shape == (2, spec.n_repeats, kw.layout.header)
    assert kw.frag.shape == (spec.n_repeats, 4, kw.layout.layer)
    x = torch.from_numpy(normal(20 + D, (33, D)))
    for direction in ("forward", "inverse"):
        want = tfs.fused_stack_reference(packed, const_ld, x, direction)
        got = _walk_kernel_layout(kw, spec, const_ld, x, direction == "inverse")
        close(got[0], want[0], 2e-5)
        close(got[1], want[1], 2e-5)


def test_input_permutation_makes_c_fragments_a_fragments():
    """Lane (g, t) holds features 8 j + 2 t and 8 j + 2 t + 1 of an output
    n-tile j; an A fragment reads k-positions t and t + 4 of k-step j: the
    permutation maps those positions to those features."""
    for fp in tfs.MMA_WIDTHS:
        perm = tfs.input_permutation(fp)
        assert sorted(perm.tolist()) == list(range(fp))
        for j in range(fp // 8):
            for t in range(4):
                assert int(perm[8 * j + t]) == 8 * j + 2 * t
                assert int(perm[8 * j + t + 4]) == 8 * j + 2 * t + 1
        # the fragments hold every weight once
        outs, ins = tfs.b_fragment_index(fp)
        assert len(set((outs * fp + ins).flatten().tolist())) == fp * fp


@pytest.mark.parametrize("D,F", [(2, 128), (9, 16)])
def test_ffma_layout_matches_reference(D, F):
    """Stacks past the tensor-core kernel (padded width 128, or D > 8)
    keep the FFMA kernel and its layout."""
    spec, packed, const_ld = _packed("realnvp", D, F)
    assert tfs.kernel_variant(D, F) == "ffma"
    kw = tfs.kernel_weights(spec, packed)
    assert isinstance(kw, tfs.FfmaWeights) and kw.fp == tfs.padded_width(F)
    x = torch.from_numpy(normal(30 + D, (21, D)))
    for direction in ("forward", "inverse"):
        want = tfs.fused_stack_reference(packed, const_ld, x, direction)
        got = _walk_ffma_layout(kw, spec, const_ld, x, direction == "inverse")
        close(got[0], want[0], 2e-5)
        close(got[1], want[1], 2e-5)


@pytest.mark.parametrize("name,D,F", [("realnvp", 400, 32), ("glow", 400, 32),
                                      ("realnvp", 400, 256), ("realnvp", 63, 256),
                                      ("glow", 150, 32), ("glow", 1300, 256)])
def test_wide_ffma_layout_matches_reference(name, D, F):
    """Past one FFMA block at 16 samples: the cluster kernel's plan and its
    layout (``ffma_weights`` on 'ffma_cluster', and at Glow D = 1,300 F =
    256 on 'ffma_cluster_spill', whose member rows pass shared memory at 16
    samples), walked over two clusters (the second ragged) against the
    plain version at 2e-5 and nf_tpu's EvalProgram: RealNVP at 2e-5, Glow
    within the spread of nf_tpu's own program over XLA's threading."""
    jmodel, var = jax_model(name, D, 4, F, seed=1)
    tmodel = torch_model(name, D, 4, F, var)
    spec = tfs.extract_stack_spec(tmodel.bijector, tmodel.dims)
    packed, const_ld = tfs.pack_stack(tmodel.bijector, spec)
    kw = tfs.kernel_weights(spec, packed)
    assert isinstance(kw, tfs.FfmaWeights)
    spill = D == 1300
    assert (kw.path, kw.tile) == ("ffma_cluster_spill" if spill else "ffma_cluster",
                                  (48, tfs.CLUSTER))
    assert tfs.smem_bytes(kw.fp, 48, D, name == "glow", True, spill) <= tfs.SMEM_LIMIT
    jprog = jmodel.eval_program(var)
    x = normal(40 + D, (70, D))
    jz, jld = jprog.forward(x)
    jy, jldi = jprog.inverse(np.asarray(jz))
    nf = {"forward": (jz, jld), "inverse": (jy, jldi)}
    inputs = {"forward": torch.from_numpy(x), "inverse": torch.tensor(np.asarray(jz))}
    for direction in ("forward", "inverse"):
        want = tfs.fused_stack_reference(packed, const_ld, inputs[direction], direction)
        got = _walk_cluster_layout(kw, spec, const_ld, inputs[direction],
                                   direction == "inverse")
        close(got[0], want[0], 2e-5)
        # at D = 1,300 the log-det is about -600, where one f32 step is
        # 6.1e-5: there rtol 1e-6 beside the atol (the sums' orders differ)
        close(got[1], want[1], 2e-5, 1e-6 if spill else 0.0)
        # RealNVP within 2e-5 of nf_tpu's program; Glow's f32 program on the
        # CPU moves with XLA's threading (tests/stack_thread_spread.py: its
        # inverse z on one core and on every core up to 1.0e-4 apart at D =
        # 400, 4.8e-4 at D = 1,300, F = 256), while the walk holds the plain
        # version to 2e-5: there the program's spread
        atol, rtol = (2e-5, 0.0) if name == "realnvp" else (5e-4, 0.0) if spill else (1e-4, 1e-4)
        close(got[0], nf[direction][0], atol, rtol)
        close(got[1], nf[direction][1], atol)


@pytest.mark.parametrize("D", [2, 9, 16, 64, 400, 1024, 3000, 20000])
def test_every_stack_has_a_plan_within_one_block(D):
    """Every (D, F) of the grid that nf_tpu fuses (F <= 256), RealNVP and
    Glow, has a kernel whose block fits 232,448 bytes: the tensor-core
    kernel, or the FFMA kernel at TILES or NARROW_TILE, the first that
    fits (NARROW_TILE outside CLUSTER_PAST_TILES' widths), or past them
    the cluster kernel, whose member fits within a cluster of 4 and the
    threads' tile budgets, its x tile in shared memory down to SPILL_BELOW
    samples, else in device memory; TILES keeps every shape it held."""
    for F in (8, 32, 100, 256):
        for mix in (False, True):
            fp = tfs.padded_width(F)
            if tfs.kernel_variant(D, F) == "mma":
                assert tfs.MmaLayout(fp, tfs.mma_dim(D)).smem_bytes <= tfs.SMEM_LIMIT
                continue
            path, tile = tfs.ffma_plan(D, F, mix)
            assert tfs.ffma_tiling(D, F, mix) == tile
            wide, spill = path.startswith("ffma_cluster"), path == "ffma_cluster_spill"
            assert tfs.smem_bytes(fp, tile[0], D, mix, wide, spill) <= tfs.SMEM_LIMIT == 232448
            fits = [tfs.smem_bytes(fp, t[0], D, mix) <= tfs.SMEM_LIMIT
                    for t in (tfs.TILES[fp], tfs.NARROW_TILE)]
            in_smem = tfs.wide_plan(D, F, mix) is not None
            narrow = fits[1] and fp not in tfs.CLUSTER_PAST_TILES[mix]
            assert path == ("ffma" if fits[0] else "ffma_narrow" if narrow else
                            "ffma_cluster" if in_smem else "ffma_cluster_spill")
            if wide:
                S, C = tile
                budget = tfs.TILE_ITEMS * tfs.CLUSTER_THREADS
                assert C == tfs.CLUSTER == 4 and S in tfs.CLUSTER_SAMPLES
                assert S >= tfs.SPILL_BELOW and (S == 48 or not spill)
                assert fp // 4 * (S // 4) <= budget and fp * -(-S // C // 4) <= budget
    assert tfs.ffma_plan(400, 32, False) == ("ffma_cluster", (48, 4))
    assert tfs.ffma_plan(1024, 32, True) == ("ffma_cluster", (32, 4))
    assert tfs.ffma_plan(1024, 256, True) == ("ffma_cluster", (16, 4))
    assert tfs.ffma_plan(213, 32, False) == ("ffma_cluster", (48, 4))
    assert tfs.ffma_plan(117, 64, False) == ("ffma_narrow", tfs.NARROW_TILE)
    assert tfs.ffma_plan(117, 64, True) == ("ffma_cluster", (48, 4))
    assert tfs.ffma_plan(29, 256, True) == ("ffma_narrow", tfs.NARROW_TILE)
    assert tfs.ffma_plan(2, 128, False) == ("ffma", tfs.TILES[128])
    assert tfs.member_rows(1024) == 256 and tfs.member_rows(400) == 100


def test_kernel_variant_follows_the_shape():
    """The tensor-core kernel up to a padded width of 64 and D <= 8, the
    FFMA kernel past either; the card tests' cases and the headline."""
    want = {(2, 32): "mma", (2, 8): "mma", (3, 20): "mma", (3, 64): "mma", (5, 64): "mma",
            (8, 64): "mma", (2, 65): "ffma", (5, 128): "ffma", (2, 256): "ffma",
            (9, 8): "ffma", (12, 32): "ffma"}
    assert {k: tfs.kernel_variant(*k) for k in want} == want
    assert [tfs.mma_dim(D) for D in (1, 2, 3, 5, 8)] == [2, 2, 8, 8, 8]
    for name in ("realnvp", "glow"):
        model = torch_model(name, 2, 2, 8)
        stack = model.eval_program().stack
        assert stack.variant == "mma" and stack.kernel is None   # CPU: no kernel layout


def test_smem_budget_covers_headline_and_wide_stacks():
    # every tensor-core tiling fits one block; the headline's block is the
    # ring of 8 layer slots (8 KB each), two headers and the mbarriers
    for fp in tfs.MMA_WIDTHS:
        for dp in tfs.MMA_DIMS:
            assert tfs.MmaLayout(fp, dp).smem_bytes <= tfs.SMEM_LIMIT
    head = tfs.MmaLayout(32, 2)
    assert head.smem_bytes == 256 + 4 * (8 * 2048 + 2 * 588) == 70496
    # the FFMA kernel's tiles for the widths past the tensor-core kernel
    for fp in (128, 256):
        assert tfs.smem_bytes(fp, tfs.TILES[fp][0], 3) <= tfs.SMEM_LIMIT
    # a cluster member at the wide path's shapes: its x rows, the
    # in-projection / head-input block, the conditioner and, for Glow, two
    # x buffers and the mix's chunk rings, 32 or 16 samples a cluster, and
    # the 48 of the main shapes
    # (the weight ring: 4 slots of 4,096 floats and their 4 mbarriers; the
    # conditioner's rows 12 floats)
    ring = 4 * 4096 + 8
    assert tfs.smem_bytes(32, 32, 1024, True, wide=True) == 4 * (
        2 * 256 * 36 + 32 * 36 + 128 * 36 + 3 * 32 * 12 + ring + 2 * 16 * (256 + 36) + 32)
    assert tfs.smem_bytes(256, 32, 400, False, wide=True) == 4 * (
        100 * 36 + 256 * 36 + 50 * 36 + 3 * 256 * 12 + ring + 32)
    assert tfs.smem_bytes(256, 16, 1024, True, wide=True) == 4 * (
        2 * 256 * 20 + 256 * 20 + 128 * 20 + 3 * 256 * 12 + ring + 2 * 16 * (256 + 20) + 16)
    # past the D whose member fits at 16 samples the x tile, the second x
    # buffer and the s rows go to device memory, and nothing left in
    # shared memory grows with D: 48 samples at any D
    for F, mix, first in ((32, False, 5313), (256, False, 3649), (32, True, 1905),
                          (256, True, 1297)):
        assert tfs.wide_plan(first - 1, F, mix) == 16 and tfs.wide_plan(first, F, mix) is None
        assert tfs.ffma_plan(first, F, mix) == ("ffma_cluster_spill", (48, 4))
        fp = tfs.padded_width(F)
        assert tfs.smem_bytes(fp, 48, first, mix, True, True) == tfs.smem_bytes(
            fp, 48, 10 ** 6, mix, True, True) <= tfs.SMEM_LIMIT
    assert tfs.smem_bytes(256, 48, 5000, True, wide=True, spill=True) == 4 * (
        256 * 52 + 3 * 256 * 12 + ring + 2 * 16 * 52 + 48)
    assert tfs.spill_floats(48, 5000, True) == (2 * 1252 + 626) * 52


# stacks nf_tpu fuses (F <= 256, 8 MB of weights, any D) whose FFMA block at
# TILES' sample count passes the shared memory: the first D past it at
# F = 32 (RealNVP, Glow) and at F = 256 with two layers
PAST_THE_BLOCK = [("realnvp", 213, 32), ("glow", 111, 32), ("realnvp", 29, 256),
                  ("glow", 27, 256)]
# past one block at 16 samples as well: the cluster kernel
PAST_ONE_BLOCK = [("realnvp", 400, 32), ("glow", 400, 32)]


@pytest.mark.parametrize("name,D,F", PAST_THE_BLOCK + PAST_ONE_BLOCK)
def test_spec_matches_nf_tpu_past_the_ffma_block(name, D, F, monkeypatch):
    """Both matchers return the same spec; the port's CPU program runs
    ``fused_stack_reference`` (no launch) and agrees with nf_tpu's
    EvalProgram within 1e-4; on the card the 16-sample tiling holds it (at
    F = 256), or the cluster kernel (at F = 32, and past the 16-sample
    tiling)."""
    jmodel, var = jax_model(name, D, 2, F, seed=2, batch=32)
    tmodel = torch_model(name, D, 2, F, var)
    jspec = jfs.extract_stack_spec(jmodel.bijector, jmodel.dims)
    tspec = tfs.extract_stack_spec(tmodel.bijector, tmodel.dims)
    assert jspec is not None and tspec is not None
    for field in ("n_repeats", "dim", "filters", "has_mix", "norm_kind", "halves"):
        assert getattr(tspec, field) == getattr(jspec, field), field
    fp = tfs.padded_width(F)
    assert tfs.smem_bytes(fp, tfs.TILES[fp][0], D, name == "glow") > tfs.SMEM_LIMIT
    assert tfs.ffma_plan(D, F, name == "glow") == (
        ("ffma_cluster", (48, tfs.CLUSTER)) if (name, D, F) in PAST_ONE_BLOCK or F == 32
        else ("ffma_narrow", tfs.NARROW_TILE))

    calls = []
    plain = tfs.fused_stack_reference
    monkeypatch.setattr(tfs, "fused_stack_reference",
                        lambda *a: calls.append(a[-1]) or plain(*a))
    prog = tmodel.eval_program()
    assert isinstance(prog.stack, tfs.PackedStack) and prog.stack.kernel is None
    jprog = jmodel.eval_program(var)
    x = normal(40 + D, (16, D))
    before = dict(tfs.LAUNCHES)
    z, ld = prog.forward(torch.from_numpy(x))
    jz, jld = jprog.forward(x)
    close(z, jz, 1e-4)
    close(ld, jld, 1e-4)
    y, ldi = prog.inverse(z)
    jy, jldi = jprog.inverse(np.asarray(jz))
    close(y, jy, 1e-4)
    close(ldi, jldi, 1e-4)
    assert calls == ["forward", "inverse"] and tfs.LAUNCHES == before


def test_stack_no_tiling_holds_raises_off_the_cpu():
    """(It pinned the refusal of a D that neither FFMA tiling holds, until
    the wide path came.)  Such a D matches (as in nf_tpu), runs its plain
    version on the CPU, and is covered on the card: the cluster kernel's
    member fits one block, its weights pack onto ``meta`` with no error
    (Glow's mix transposed for it), and no launch is counted."""
    D, F = 400, 32
    assert tfs.smem_bytes(32, tfs.NARROW_TILE[0], D, False) > tfs.SMEM_LIMIT
    assert tfs.ffma_plan(D, F, False) == ("ffma_cluster", (48, tfs.CLUSTER))
    assert tfs.smem_bytes(32, 48, D, False, wide=True) <= tfs.SMEM_LIMIT
    tmodel = torch_realnvp(D, 2, F)
    spec = tfs.extract_stack_spec(tmodel.bijector, tmodel.dims)
    assert spec is not None and tfs.kernel_variant(D, F) == "ffma"
    packed, const_ld = tfs.pack_stack(tmodel.bijector, spec)
    before = dict(tfs.LAUNCHES)
    stack = tfs.PackedStack(spec, packed, const_ld)
    assert stack.kernel is None
    x = torch.from_numpy(normal(7, (5, D)))
    close(tfs.fused_stack(stack, x, "forward")[0],
          tfs.fused_stack_reference(packed, const_ld, x, "forward")[0], 0.0)
    meta = [{k: v.to("meta") for k, v in p.items()} for p in packed]
    kw = tfs.ffma_weights(spec, meta)
    assert kw.path == "ffma_cluster" and kw.w0t.device.type == "meta"
    gspec = tfs.extract_stack_spec(torch_model("glow", D, 2, F).bijector, (D,))
    gmeta = [{k: v.to("meta") for k, v in p.items()}
             for p in tfs.pack_stack(torch_model("glow", D, 2, F).bijector, gspec)[0]]
    gkw = tfs.ffma_weights(gspec, gmeta)
    assert gkw.mix.shape == gkw.mixi.shape == (2, D, tfs.CLUSTER * tfs.member_rows(D))
    assert tfs.LAUNCHES == before


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
