"""The port's fused ResFlow module against nf_tpu's Pallas kernels, on the CPU.

* spec fields, and None for stacks that are not ResFlow; stacks past the
  tiled kernels' widths match as in nf_tpu and take the wide kernel;
* ``pack_resflow`` against nf_tpu's, key by key, atol 1e-6;
* each plain version against its Pallas kernel in interpret mode, with
  nf_tpu's probes injected (``draw_unbias_probes``: V, thr, cap): the
  tolerances of tests/test_pallas.py, forward z 1e-5 and log-det 1e-4,
  inverse x 5e-4 and log-det 1e-3 (the fixed point stops within ftol);
* the kernel's own weight layout, walked in PyTorch the way the CUDA
  kernel walks it (both F x F products from the block's fragment arrays
  in 3xTF32, emulated bit for bit: big rounded to TF32 on the host, the
  column side truncated, the small parts truncated as the tensor core
  reads them, in k-steps of 8), against the plain versions at padded
  widths up to F = 256, 2e-5, and at F = 256 against the Pallas kernels
  in interpret mode; the fragment layout and the probes' pairing;
* the solve kernel of padded widths 16 to 64 (a warp per 8 samples) walked
  lane by lane: h1 in the mma B layout, W2t h1 in 3xTF32, the C-layout
  fold and its shuffle reduction, each warp's own stopping; against the
  plain version 2e-5 and nf_tpu's solve kernel in interpret mode 5e-4, on
  ragged batches; which kernel each width takes, and its weight ring;
* the wide kernel (F past 256 or D past 8): its layout and partition
  walked in PyTorch as the kernel walks them (W1t, W2t's and W3t's
  fragments decoded from ``wide_weights``, W2t's row slabs one per cluster
  member with the D-wide partials summed in member order, every product J
  w, the probes side by side), against the plain versions 2e-5, per
  cluster of the plan's samples within the fixed point's tolerance; the
  fragment order and the probes' order; the plain versions at (D, F) =
  (2, 512) and (16, 64) against nf_tpu's Pallas kernels in interpret mode;
  every (D, F) of a grid up to 1024 x 4096 planned within one block's
  shared memory on a cluster size the card schedules;
* the wrapper: the plain versions for CPU tensors, no launch counted.
"""
import jax
import numpy as np
import pytest
import torch
from _torch_parity import close, jax_model, nf_unbias_probes, normal, torch_model

from nf_tpu.ops.pallas import fused_resflow as jfr
from nf_tpu_torch.ops.cuda import fused_resflow as tfr


def _t(a):
    return torch.tensor(np.asarray(a))


def _both(D, F, layers=4, seed=0, logdet="unbias"):
    jmodel, var = jax_model("resflow", D, layers, F, seed=seed, logdet=logdet)
    tmodel = torch_model("resflow", D, layers, F, var, logdet=logdet)
    jspec = jfr.extract_resflow_spec(jmodel.bijector, jmodel.dims)
    tspec = tfr.extract_resflow_spec(tmodel.bijector, tmodel.dims)
    return jmodel, var, jspec, tmodel, tspec


@pytest.mark.parametrize("D,F,logdet", [(2, 8, "unbias"), (3, 32, "exact")])
def test_spec_matches(D, F, logdet):
    _, _, jspec, _, tspec = _both(D, F, logdet=logdet)
    assert jspec is not None and tspec is not None
    for field in ("kind", "n_repeats", "dim", "filters", "n_iters", "ftol", "estimator"):
        assert getattr(tspec, field) == getattr(jspec, field), field


@pytest.mark.parametrize("name", ["realnvp", "glow", "flow++"])
def test_spec_rejects_nonmatching(name):
    from nf_tpu.config import NetworkConfig
    from nf_tpu.models import build_model

    jm = build_model(name, (2,), datatype="2d",
                     cfg=NetworkConfig(name=name, layers=4, mixtures=4))
    tm = torch_model(name, 2, 4, 32)
    assert jfr.extract_resflow_spec(jm.bijector, jm.dims) is None
    assert tfr.extract_resflow_spec(tm.bijector, tm.dims) is None


def test_spec_past_the_tiled_kernels_takes_the_wide_kernel():
    """A stack wider than the tiled kernels matches as in nf_tpu and is
    covered: the wide kernel takes it, its plan fits one
    block, its weights pack onto ``meta`` with no error, the plain versions
    run it on the CPU, and no launch is counted."""
    for D, F in ((2, 512), (9, 8)):
        jmodel, var, jspec, tmodel, tspec = _both(D, F, layers=2)
        assert jspec is not None and tspec is not None and tspec.filters == jspec.filters
        assert tfr.covers(tspec) and tfr.kernel_path(tspec) == "wide"
        assert tfr.wide_plan(F, D, 16).smem_bytes <= tfr.SMEM_LIMIT
        packed = tfr.pack_resflow(tmodel.bijector, tspec)
        stack = tfr.PackedResFlow(tspec, packed)
        x = torch.from_numpy(normal(5, (16, D)))
        probes = tfr.draw_unbias_probes(16, D, torch.Generator().manual_seed(2))
        before = dict(tfr.LAUNCHES)
        z, _ = tfr.fused_resflow(stack, x, "forward", probes)
        close(tfr.fused_resflow(stack, z, "solve"), x, 1e-4)
        kw = tfr.wide_weights(tspec, {k: v.to("meta") for k, v in packed.items()})
        assert kw.w.device.type == "meta"
        C = tfr.wide_cluster(F, D)
        assert kw.cluster == C and kw.w.shape == (2, tfr.wide_geometry(
            F, D, C, 8, 32, 16, False, False, False, False, False)["size"])
        assert tfr.LAUNCHES == before
    widest = torch_model("resflow", 8, 2, 256)
    spec = tfr.extract_resflow_spec(widest.bijector, widest.dims)
    assert tfr.covers(spec) and tfr.kernel_path(spec) == "tile"


@pytest.mark.parametrize("D,F", [(2, 8), (3, 32)])
def test_pack_resflow_matches(D, F):
    jmodel, var, jspec, tmodel, tspec = _both(D, F)
    jpacked = jfr.pack_resflow(jmodel.bijector, jspec, var)
    tpacked = tfr.pack_resflow(tmodel.bijector, tspec)
    assert list(tpacked) == list(jpacked)
    for key, arr in jpacked.items():
        assert tuple(tpacked[key].shape) == np.shape(arr), key
        close(tpacked[key], arr, 1e-6)


@pytest.mark.parametrize("D,F", [(2, 8), (2, 32), (3, 32), (2, 256)])
def test_plain_versions_match_pallas_interpret(D, F):
    jmodel, var, jspec, tmodel, tspec = _both(D, F, seed=D + F)
    packed = tfr.pack_resflow(tmodel.bijector, tspec)
    probes = nf_unbias_probes(256, D)
    x = normal(10 + D, (256, D), 1.5)

    jz, jld = jfr.fused_resflow_forward(jmodel.bijector, jspec, var, x, interpret=True)
    z, ld = tfr.fused_resflow_fwd_logdet_reference(tspec, packed, _t(x), probes)
    close(z, jz, 1e-5)
    close(ld, jld, 1e-4)

    jx, jldi = jfr.fused_resflow_inverse(jmodel.bijector, jspec, var, np.asarray(jz),
                                         interpret=True)
    xi, ldi = tfr.fused_resflow_solve_logdet_reference(tspec, packed, _t(jz), probes)
    close(xi, jx, 5e-4)
    close(ldi, jldi, 1e-3)

    jxs = jfr.fused_resflow_inverse_solve(jmodel.bijector, jspec, var, np.asarray(jz),
                                          interpret=True)
    trips = []
    xs = tfr.fused_resflow_solve_reference(tspec, packed, _t(jz), trips)
    close(xs, jxs, 5e-4)
    assert len(trips) == tspec.n_repeats and all(1 <= t < tspec.n_iters for t in trips)


def _trunc_tf32(x):
    """What a tensor core reads of an f32 operand: its top 19 bits."""
    return (x.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _unfragment(frags, fp):
    """The kernel's A fragments (KS, MT, 2, 32, 4) back to the (big, small)
    (FP, FP) matrices they hold."""
    rows, cols = tfr.fragment_index(fp)
    big, small = torch.zeros(fp, fp), torch.zeros(fp, fp)
    big[rows, cols] = frags[:, :, 0]
    small[rows, cols] = frags[:, :, 1]
    return big, small


def _mm3_ktiled(b, a_big, a_small):
    """b @ A^T as the kernel's mma.sync chain computes it: per k-step of 8
    features, A's big part (rounded on the host) and small part, b
    truncated to TF32 (big) with the rest truncated again as the tensor
    core reads it (small); small products first, accumulated in f32."""
    bb = _trunc_tf32(b)
    bs = _trunc_tf32(b - bb)
    a_small = _trunc_tf32(a_small)
    acc = torch.zeros(b.shape[:-1] + (a_big.shape[0],))
    for k0 in range(0, a_big.shape[1], 8):
        ks = slice(k0, k0 + 8)
        acc = acc + bs[..., ks] @ a_big[:, ks].T
        acc = acc + bb[..., ks] @ a_small[:, ks].T
        acc = acc + bb[..., ks] @ a_big[:, ks].T
    return acc


def _walk_kernel_layout(kw, spec, x, direction, probes=None):
    """The CUDA kernel's walk in PyTorch, reading ``KernelWeights``' one
    block per residual block at the padded width FP and dimension DP: both
    F x F products (W2t h1 in g, W2 t in the series) from the block's
    fragment arrays in 3xTF32, walked in k-steps of 8."""
    lay = tfr.Layout(kw.fp, kw.dp)
    fp, dp, D = kw.fp, kw.dp, spec.dim
    frag = (fp // 8, fp // 16, 2, 32, 4)
    B = x.shape[0]
    xp = torch.zeros(B, dp)
    xp[:, :D] = x
    Vp = None
    if probes is not None:
        Vp = torch.zeros(4, B, dp)
        Vp[:, :, :D] = probes[0]
    acc = torch.zeros(B)
    order = range(spec.n_repeats)
    for j in (reversed(order) if direction != "forward" else order):
        w = kw.w[j]
        w1t, w3t = w[lay.w1t:lay.b1].view(fp, dp), w[lay.w3t:lay.b3].view(dp, fp)
        b1, b2, b3 = w[lay.b1:lay.b2], w[lay.b2:lay.w3t], w[lay.b3:lay.an_s]
        an_s, an_b, beta = w[lay.an_s:lay.an_b], w[lay.an_b:lay.beta], w[lay.beta:lay.beta + 2]
        w2 = _unfragment(w[lay.w2:lay.w2t].view(frag), fp)
        w2t = _unfragment(w[lay.w2t:lay.size].view(frag), fp)

        def hidden(xx):
            h1, d1 = tfr._lipswish(xx @ w1t.T + b1, beta[0])
            h2, d2 = tfr._lipswish(_mm3_ktiled(h1, *w2t) + b2, beta[1])
            return h2, d1, d2

        def g(xx):
            return hidden(xx)[0] @ w3t.T + b3

        if direction == "forward":
            xp = (xp - an_b) * torch.exp(-an_s)
            zz = xp + g(xp)
        else:
            zz, prev, it = xp, xp, 1
            xp = zz - g(zz)
            while it < spec.n_iters and float((xp - prev).abs().max()) >= spec.ftol:
                xp, prev, it = zz - g(xp), xp, it + 1
        if Vp is not None:
            _, d1, d2 = hidden(xp)
            wv, ser = Vp, torch.zeros(4, B)
            for k in range(1, int(max(probes[1])) + 1):
                if fp * dp <= 64:   # the kernel's kRegW: the masks in the weights
                    t = (wv[:, :, :, None] * (w3t[None, :, :] * d2[:, None, :])).sum(2)
                    u = _mm3_ktiled(t, *w2)
                    wv = (u[:, :, :, None] * (w1t[None] * d1[:, :, None])).sum(2)
                else:
                    t = (wv @ w3t) * d2
                    wv = (_mm3_ktiled(t, *w2) * d1) @ w1t
                live = torch.tensor([float(k <= int(n)) for n in probes[1]])
                coef = (1.0 if k % 2 else -1.0) * 2.0 ** max(0, k - 9) / k
                ser = ser + (live * coef)[:, None] * (wv * Vp).sum(2)
            acc = acc + (ser[0] + ser[1] + ser[2] + ser[3]) / 4.0
        xp = zz if direction == "forward" else xp * torch.exp(an_s) + an_b
    return xp[:, :D], acc


def _walk_solve_warps(kw, spec, z):
    """csrc/fused_resflow.cu's fused_resflow_solve_kernel in PyTorch, lane by
    lane: a warp per 8 samples (lane 4 g + t on sample g), h1 formed in the
    mma B layout (features 8 ks + t, + 4 of sample g), W2t h1 in 3xTF32 from
    the slot's fragments, h2 and the W3t fold in the C layout (rows 16 mt +
    g, + 8; columns 2 t, 2 t + 1), the xor-4 / 8 / 16 reduction that keeps
    one column and sends the other, the gather of sample g from lane
    4 (g & 1) + (g >> 1), and each warp's own fixed-point stopping.
    LipSwish is the plain version's; the kernel's __expf / __fdividef form
    differs from it by a few f32 ulps."""
    lay = tfr.Layout(kw.fp, kw.dp)
    fp, dp, D = kw.fp, kw.dp, spec.dim
    MT, KS = fp // 16, fp // 8
    B = z.shape[0]
    nw = -(-B // 8)
    lane = torch.arange(32)
    g, t = lane // 4, lane % 4
    odd = g % 2
    src = 4 * odd + g // 2
    xp = torch.zeros(nw * 8, dp)
    xp[:B, :D] = z
    valid = (torch.arange(nw * 8) < B).view(nw, 8)
    for j in reversed(range(spec.n_repeats)):
        w = kw.w[j]
        w1t, w3t = w[lay.w1t:lay.b1].view(fp, dp), w[lay.w3t:lay.b3].view(dp, fp)
        b1, b2, b3 = w[lay.b1:lay.b2], w[lay.b2:lay.w3t], w[lay.b3:lay.an_s]
        an_s, an_b, beta = w[lay.an_s:lay.an_b], w[lay.an_b:lay.beta], w[lay.beta:lay.beta + 2]
        big, small = _unfragment(w[lay.w2t:lay.size].view(fp // 8, MT, 2, 32, 4), fp)

        def g_of(xx):
            """(nw, 8, dp) -> g at each warp's samples, as lane 4 g holds it."""
            lane_x = xx[:, g]                                     # (nw, 32, dp)
            f = 8 * torch.arange(KS)[:, None, None] + t[None, :, None] \
                + 4 * torch.arange(2)[None, None, :]              # (KS, 32, 2)
            a = (lane_x[:, None, :, None, :] * w1t[f][None]).sum(-1) + b1[f]
            h1, _ = tfr._lipswish(a, beta[0])                     # (nw, KS, 32, 2)
            bmat = torch.zeros(xx.shape[0], fp, 8)                # B[k][n]
            bmat[:, f, g[None, :, None].expand_as(f)] = h1
            out = _mm3_ktiled(bmat.transpose(1, 2), big, small)   # (nw, 8 n, fp o)
            gp = torch.zeros(xx.shape[0], 32, 2, dp)
            for mt in range(MT):
                for r in range(4):
                    o, c = 16 * mt + g + 8 * (r // 2), r % 2
                    h2, _ = tfr._lipswish(out[:, 2 * t + c, o] + b2[o], beta[1])
                    gp[:, :, c] += h2[..., None] * w3t.T[o]
            keep = torch.where(odd[:, None].bool(), gp[:, :, 1], gp[:, :, 0])
            send = torch.where(odd[:, None].bool(), gp[:, :, 0], gp[:, :, 1])
            red = keep + send[:, lane ^ 4]
            red = red + red[:, lane ^ 8]
            red = red + red[:, lane ^ 16]
            gout = red[:, src] + b3                               # (nw, 32, dp)
            assert torch.equal(gout, gout.view(-1, 8, 4, dp)[:, :, :1].expand(-1, 8, 4, dp)
                               .reshape(gout.shape))              # a quad agrees
            return gout[:, ::4]

        zz = xp.view(nw, 8, dp)
        x, prev = zz - g_of(zz), zz
        for _ in range(1, spec.n_iters):
            moving = (((x - prev).abs() >= spec.ftol) & valid[..., None]).flatten(1).any(1)
            if not bool(moving.any()):
                break
            prev = x
            x = torch.where(moving[:, None, None], zz - g_of(x), x)
        xp = (x * torch.exp(an_s) + an_b).reshape(nw * 8, dp)
    return xp[:B, :D]


@pytest.mark.parametrize("D,F,B", [(2, 8, 37), (3, 20, 45), (2, 32, 29), (8, 64, 21)])
def test_solve_warp_layout_matches_plain_and_pallas(D, F, B):
    """The warp-per-8-samples solve walked in PyTorch against the plain
    version (2e-5) and nf_tpu's solve kernel in interpret mode (5e-4), on a
    ragged batch."""
    jmodel, var, jspec, tmodel, tspec = _both(D, F, layers=3, seed=F + D)
    packed = tfr.pack_resflow(tmodel.bijector, tspec)
    kw = tfr.kernel_weights(tspec, packed)
    assert tfr.solve_kernel(kw.fp) == "warp"
    z = normal(40 + D, (B, D), 1.5)
    x = _walk_solve_warps(kw, tspec, _t(z))
    close(x, tfr.fused_resflow_solve_reference(tspec, packed, _t(z)), 2e-5)
    jx = jfr.fused_resflow_inverse_solve(jmodel.bijector, jspec, var, z, interpret=True)
    close(x, jx, 5e-4)


def test_solve_dispatch_and_ring():
    """FP <= 64 takes the warp-per-8-samples kernel, FP = 128 and 256 variant
    0 (16-sample tiles); the ring slot holds the block's small tensors and
    its W2t fragments, 8,992 bytes at FP = 32, DP = 2, and four slots fit
    the block's shared memory with room for six blocks an SM."""
    assert [tfr.solve_kernel(fp) for fp in tfr.WIDTHS] == ["warp"] * 3 + ["tile"] * 2
    assert tfr.SOLVE_WIDTHS == (16, 32, 64) and tfr.SOLVE_WARPS == 4
    assert 4 * tfr.solve_slot_floats(32, 2) == 8992
    assert tfr.solve_slots(32) == 4 and tfr.solve_slots(64) == 2
    assert tfr.solve_smem_bytes(32, 2) == 128 + 4 * 8992
    assert 6 * (tfr.solve_smem_bytes(32, 2) + 1024) <= 228 * 1024
    for fp in tfr.SOLVE_WIDTHS:
        for dp in tfr.DIMS:
            assert tfr.solve_smem_bytes(fp, dp) <= tfr.SMEM_LIMIT
            assert (4 * tfr.solve_slot_floats(fp, dp)) % 16 == 0
    assert tfr.solve_blocks(8192) == 256 and tfr.solve_blocks(8193) == 257
    tmodel = torch_model("resflow", 2, 32, 32)
    spec = tfr.extract_resflow_spec(tmodel.bijector, tmodel.dims)
    kw = tfr.kernel_weights(spec, tfr.pack_resflow(tmodel.bijector, spec))
    assert tfr.solve_weight_bytes_to_sm(kw, 32, 8192) == 256 * 32 * 8992


@pytest.mark.parametrize("D,F", [(3, 20), (2, 8), (5, 40), (2, 100), (2, 256), (8, 200)])
def test_kernel_layout_matches_plain_versions(D, F):
    tmodel = torch_model("resflow", D, 3, F)
    tmodel.init(torch.Generator().manual_seed(D * F))
    with torch.no_grad():
        for layer in tmodel.bijector.layers[::2]:
            layer.log_scale.normal_(0.0, 0.3)
            layer.bias.normal_(0.0, 0.3)
    spec = tfr.extract_resflow_spec(tmodel.bijector, tmodel.dims)
    packed = tfr.pack_resflow(tmodel.bijector, spec)
    kw = tfr.kernel_weights(spec, packed)
    assert (kw.fp, kw.dp) == (tfr.padded_width(F), tfr.padded_dim(D))
    assert kw.w.shape == (spec.n_repeats, tfr.Layout(kw.fp, kw.dp).size)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(37, D, generator=g)
    probes = tfr.draw_unbias_probes(37, D, g)
    const = packed["an_const"]

    z, ld = tfr.fused_resflow_fwd_logdet_reference(spec, packed, x, probes)
    wz, wacc = _walk_kernel_layout(kw, spec, x, "forward", probes)
    close(wz, z, 2e-5)
    close(wacc - const, ld, 2e-5)
    xi, ldi = tfr.fused_resflow_solve_logdet_reference(spec, packed, z, probes)
    wx, wacc = _walk_kernel_layout(kw, spec, z, "inverse", probes)
    close(wx, xi, 2e-5)
    close(const - wacc, ldi, 2e-5)
    if tfr.solve_kernel(kw.fp) == "warp":
        wx = _walk_solve_warps(kw, spec, z)
    else:
        wx, _ = _walk_kernel_layout(kw, spec, z, "solve")
    close(wx, tfr.fused_resflow_solve_reference(spec, packed, z), 2e-5)


def test_kernel_walk_matches_pallas_interpret():
    """The kernel's walk against nf_tpu's Pallas kernels in interpret mode
    on the same probes, at F = 256 (streamed fragments): forward z 1e-5 and
    log-det 1e-4, inverse x 5e-4 and log-det 1e-3, as
    test_plain_versions_match_pallas_interpret holds the plain versions."""
    D, F = 2, 256
    jmodel, var, jspec, tmodel, tspec = _both(D, F, layers=2, seed=7)
    packed = tfr.pack_resflow(tmodel.bijector, tspec)
    kw = tfr.kernel_weights(tspec, packed)
    probes = nf_unbias_probes(64, D)
    x = normal(31, (64, D), 1.5)
    const = packed["an_const"]
    jz, jld = jfr.fused_resflow_forward(jmodel.bijector, jspec, var, x, interpret=True)
    wz, wacc = _walk_kernel_layout(kw, tspec, _t(x), "forward", probes)
    close(wz, jz, 1e-5)
    close(wacc - const, jld, 1e-4)
    jx, jldi = jfr.fused_resflow_inverse(jmodel.bijector, jspec, var, np.asarray(jz),
                                         interpret=True)
    wx, wacc = _walk_kernel_layout(kw, tspec, _t(jz), "inverse", probes)
    close(wx, jx, 5e-4)
    close(const - wacc, jldi, 1e-3)


def test_fragments_split_w2_for_3xtf32():
    """kernel_weights' fragment arrays hold W2 = w2t^T (the series) and
    w2t (g) at their (row, column) as fragment_index places them, big
    rounded to TF32 and big + small = the weight exactly."""
    tmodel = torch_model("resflow", 2, 2, 24)
    tmodel.init(torch.Generator().manual_seed(5))
    spec = tfr.extract_resflow_spec(tmodel.bijector, tmodel.dims)
    packed = tfr.pack_resflow(tmodel.bijector, spec)
    kw = tfr.kernel_weights(spec, packed)
    lay, fp = tfr.Layout(kw.fp, kw.dp), kw.fp
    frag = (fp // 8, fp // 16, 2, 32, 4)
    for j in range(spec.n_repeats):
        want = torch.zeros(fp, fp)
        want[:24, :24] = packed["w2t"][j]
        for off, end, mat in ((lay.w2, lay.w2t, want.T), (lay.w2t, lay.size, want)):
            big, small = _unfragment(kw.w[j, off:end].view(frag), fp)
            assert torch.equal(big + small, mat)
            assert torch.equal(big, tfr.tf32_round(mat.contiguous()))
            assert bool((small.abs() <= 2.0 ** -11 * mat.abs()).all())
    rows, cols = tfr.fragment_index(32)
    assert (rows[1, 1, 13].tolist(), cols[1, 1, 13].tolist()) == ([19, 27, 19, 27],
                                                                 [9, 9, 13, 13])


def test_probe_pairs_balance_the_block():
    """The two warps of a group take the probes {a, d} and {b, c} (a >= b
    >= c >= d), the longer first: a block runs max(a + d, b + c) terms."""
    assert tfr.probe_pairs([10, 14, 9, 9]) == [1, 3, 0, 2]
    assert tfr.probe_pairs([3, 3, 3, 3]) == [0, 3, 1, 2]
    assert tfr.probe_pairs([1, 2, 40, 5]) == [2, 0, 3, 1]
    for nt in ([10, 14, 9, 9], [10, 9, 12, 9], [40, 9, 9, 9]):
        a, d, b, c = tfr.probe_pairs(nt)
        assert nt[a] >= nt[d] and nt[b] >= nt[c] and sorted([a, b, c, d]) == [0, 1, 2, 3]
        assert max(nt[a] + nt[d], nt[b] + nt[c]) <= (sum(nt) + max(nt)) // 2


def test_kernel_tilings():
    """The (FP, DP) tilings the kernel is built for, as
    csrc/fused_resflow.cu lists them: all fit one block's shared memory;
    up to FP = 64 the whole weight block is staged, from FP = 128 only its
    small tensors and the fragments stream through each warp's ring."""
    assert tfr.WIDTHS == (16, 32, 64, 128, 256) and tfr.DIMS == (2, 4, 8)
    for fp in tfr.WIDTHS:
        for dp in tfr.DIMS:
            lay = tfr.Layout(fp, dp)
            assert lay.size % 4 == 0 and lay.small % 4 == 0
            assert lay.size == lay.small + 4 * fp * fp
            assert lay.staged == (lay.small if fp >= 128 else lay.size)
            assert tfr.smem_bytes(fp, dp) <= tfr.SMEM_LIMIT
    assert tfr.Layout(32, 2).small == 2 * 32 * 2 + 2 * 32 + 3 * 2 + 2
    assert tfr.Layout(32, 2).size == 200 + 4 * 32 * 32
    # the main path's block (F = 32, D = 2): four fit one SM's 228 KB
    assert tfr.smem_bytes(32, 2) == 4 * (2 * 4296 + 3 * 32 * 24 + 4 * 16 + 2 * 16 * 2)
    assert 4 * (tfr.smem_bytes(32, 2) + 1024) <= 228 * 1024
    # F = 256: a ring of two 8-m-tile chunks per warp
    assert tfr.Layout(256, 8).ring == 2 * 8 * 256
    assert tfr.smem_bytes(256, 8) == 4 * (2 * 4636 + 4 * 4096 + 3 * 256 * 24 + 64 + 256)
    assert tfr.SAMPLES == 16 and tfr.WARPS == 4


def _wide_unfragment(flat, M, K, k_major):
    """The (M, K) matrix whose ``wide_fragments`` is ``flat``."""
    mat = torch.zeros(M, K)
    src = torch.arange(M * K, dtype=torch.float32).view(1, M, K)
    where = tfr.wide_fragments(src, k_major).long()[0]
    mat.view(-1)[where] = flat
    return mat


def _wide_parts(kw, spec, j):
    """Residual block j of ``WideWeights``, decoded from its offsets: the
    biases, W1t (FP, D), W2t (FP, FP) and W3t (DP16, FP) of its fragments."""
    F, D = spec.filters, spec.dim
    geo = tfr.wide_geometry(F, D, kw.cluster, 8, 32, 16, False, False, False, False, False)
    FP, DP16, w = geo["FP"], geo["DP16"], kw.w[j]

    def part(name, n):
        return w[geo["o_" + name]:geo["o_" + name] + n]

    return {"b1": part("b1", FP), "b2": part("b2", FP), "b3": part("b3", D),
            "an_s": part("an_s", D), "an_b": part("an_b", D), "beta": part("beta", 2),
            "w1t": part("w1", FP * D).view(FP, D),
            "w2t": _wide_unfragment(w[geo["o_w2"]:geo["o_w3"]], FP, FP, False),
            "w3t": _wide_unfragment(w[geo["o_w3"]:geo["size"]], DP16, FP, True)[:D]}


def _walk_wide(kw, spec, x, direction, probes=None, samples=None):
    """The wide kernel's walk in PyTorch, from ``WideWeights``' layout and its
    partition: clusters of ``samples`` samples (the whole batch by default),
    each stopping its fixed point on its own; member m of ``kw.cluster``
    multiplies by its slab of W2t's rows and stage C over them, the D-wide
    partials summed in member order; every product J w = W3t (d2 * (W2t
    (d1 * (W1t w)))), the series' probes side by side (longest first,
    ``series_order``; a probe drops out when its series ends)."""
    B, D, C = x.shape[0], spec.dim, kw.cluster
    samples = samples or B
    n, coef = spec.n_repeats, [0.0] + [(1.0 if k % 2 else -1.0) * 2.0 ** max(0, k - 9) / k
                                       for k in range(1, 41)]
    outs, accs = [], []
    for t0 in range(0, B, samples):
        xp = x[t0:t0 + samples].clone()
        acc = torch.zeros(xp.shape[0])
        for j in (range(n) if direction == "forward" else reversed(range(n))):
            P = _wide_parts(kw, spec, j)
            Fs = P["w2t"].shape[0] // C

            def chain(inp, d1=None, d2=None):
                """(g's output layer partials or J inp, d1, d2)."""
                a = inp @ P["w1t"].T
                if d1 is None:
                    a, d1 = tfr._lipswish(a + P["b1"], P["beta"][0])
                else:
                    a = a * d1
                parts, masks = [], []
                for m in range(C):
                    rows = slice(m * Fs, (m + 1) * Fs)
                    c = a @ P["w2t"][rows].T
                    if d2 is None:
                        c, dm = tfr._lipswish(c + P["b2"][rows], P["beta"][1])
                        masks.append(dm)
                    else:
                        c = c * d2[:, rows]
                    parts.append(c @ P["w3t"][:, rows].T)
                out = parts[0]
                for q in parts[1:]:
                    out = out + q
                return out, d1, (torch.cat(masks, 1) if d2 is None else d2)

            if direction == "forward":
                xp = (xp - P["an_b"]) * torch.exp(-P["an_s"])
                gx, d1, d2 = chain(xp)
                gx = gx + P["b3"]
            else:
                z = xp
                for it in range(1, spec.n_iters + 1):
                    new = z - (chain(xp)[0] + P["b3"])
                    moving = float((new - xp).abs().max()) >= spec.ftol
                    xp = new
                    if not moving:
                        break
                _, d1, d2 = chain(xp)
            if probes is not None:
                order = tfr.series_order(probes[1])
                nt = [int(probes[1][q]) for q in order]
                V = torch.stack([probes[0][q, t0:t0 + samples] for q in order])
                wv, ser = V.clone(), torch.zeros(4, xp.shape[0])
                for k in range(1, nt[0] + 1):
                    live = sum(t >= k for t in nt)
                    for q in range(live):
                        wv[q] = chain(wv[q], d1, d2)[0]
                        ser[order[q]] = ser[order[q]] + coef[k] * (wv[q] * V[q]).sum(1)
                acc = acc + (ser[0] + ser[1] + ser[2] + ser[3]) * 0.25
            xp = xp + gx if direction == "forward" else xp * torch.exp(P["an_s"]) + P["an_b"]
        outs.append(xp)
        accs.append(acc)
    return torch.cat(outs), torch.cat(accs)


@pytest.mark.parametrize("D,F,B", [(2, 512, 21), (16, 64, 21), (9, 8, 21), (3, 300, 21),
                                   (2, 2048, 9)])
def test_wide_layout_matches_plain_versions(D, F, B):
    """The wide kernel's layout and partition walked in PyTorch (2 blocks)
    against the plain versions, 2e-5: (2, 512), (3, 300) and (2, 2048) on 2
    members reading W2t's slabs from L2, (16, 64) and (9, 8) one block
    holding all of W2t, and (2, 512) also on 8 members holding theirs; the
    inverse also per cluster of the plan's samples (8 at B = 21), as the
    kernel stops, within the fixed point's tolerance."""
    tmodel = torch_model("resflow", D, 2, F)
    tmodel.init(torch.Generator().manual_seed(D + F))
    with torch.no_grad():
        for layer in tmodel.bijector.layers[::2]:
            layer.log_scale.normal_(0.0, 0.3)
            layer.bias.normal_(0.0, 0.3)
    spec = tfr.extract_resflow_spec(tmodel.bijector, tmodel.dims)
    assert tfr.kernel_path(spec) == "wide"
    packed = tfr.pack_resflow(tmodel.bijector, spec)
    kw = tfr.wide_weights(spec, packed)
    plan = tfr.wide_plan(F, D, B, cluster=kw.cluster)
    want = {(2, 512): (2, "streamed"), (16, 64): (1, "one block"), (9, 8): (1, "one block"),
            (3, 300): (2, "streamed"), (2, 2048): (2, "streamed")}[(D, F)]
    assert (kw.cluster, plan.residency) == want and plan.samples == 8
    geo = tfr.wide_geometry(F, D, kw.cluster, 8, 32, 16, False, False, False, False, False)
    FP = -(-F // (16 * kw.cluster)) * 16 * kw.cluster
    assert kw.w.shape == (2, geo["size"]) and geo["FP"] == FP
    assert geo["size"] == (2 * FP + 3 * geo["DP16"] + 2 + 3) // 4 * 4 + (FP * D + 3) // 4 * 4 \
        + FP * FP + geo["DP16"] * FP
    g = torch.Generator().manual_seed(3)
    x = torch.randn(B, D, generator=g)
    probes = tfr.draw_unbias_probes(B, D, g)
    const = packed["an_const"]
    z, ld = tfr.fused_resflow_fwd_logdet_reference(spec, packed, x, probes)
    wz, wacc = _walk_wide(kw, spec, x, "forward", probes)
    close(wz, z, 2e-5)
    close(wacc - const, ld, 2e-5)
    xi, ldi = tfr.fused_resflow_solve_logdet_reference(spec, packed, z, probes)
    wx, wacc = _walk_wide(kw, spec, z, "inverse", probes)
    close(wx, xi, 2e-5)
    close(const - wacc, ldi, 2e-5)
    wx, _ = _walk_wide(kw, spec, z, "solve")
    close(wx, tfr.fused_resflow_solve_reference(spec, packed, z), 2e-5)
    wx, wacc = _walk_wide(kw, spec, z, "inverse", probes, samples=plan.samples)
    close(wx, xi, 1e-3)
    close(const - wacc, ldi, 1e-3)
    if (D, F) == (2, 512):
        kw8 = tfr.wide_weights(spec, packed, 8)
        assert tfr.wide_plan(F, D, B, cluster=8).residency == "cluster"
        wz, wacc = _walk_wide(kw8, spec, x, "forward", probes)
        close(wz, z, 2e-5)
        close(wacc - const, ld, 2e-5)


def test_wide_fragments_and_series_order():
    """``wide_fragments`` puts W2t's entry (r, k) where lane 4 (r % 8) + k % 4
    of m-tile r // 16 and k-step k // 8 holds it (register (r // 8) % 2 + 2
    ((k // 4) % 2)), m-tile major, and W3t's k-step major; member m's slab of
    W2t is its contiguous m-tiles [m Fs / 16, ...) and its W3t columns a
    contiguous k-step range.  ``series_order``: longest first, ties by index."""
    M, K = 32, 48
    mat = torch.arange(M * K, dtype=torch.float32).view(1, M, K)
    flat = tfr.wide_fragments(mat, False)[0].view(M // 16, K // 8, 32, 4)
    for r, k in ((0, 0), (9, 5), (17, 44), (31, 47)):
        lane, reg = 4 * (r % 8) + k % 4, (r // 8) % 2 + 2 * ((k // 4) % 2)
        assert float(flat[r // 16, k // 8, lane, reg]) == float(mat[0, r, k])
    kflat = tfr.wide_fragments(mat, True)[0].view(K // 8, M // 16, 32, 4)
    assert torch.equal(kflat.transpose(0, 1), flat)
    Fs = 16
    slab = flat[1]  # member 1 of 2: rows 16 .. 31
    assert torch.equal(slab.reshape(-1).sort().values,
                       mat[0, Fs:2 * Fs].reshape(-1).sort().values)
    assert tfr.series_order([10, 14, 9, 9]) == [1, 0, 2, 3]
    assert tfr.series_order([3, 3, 3, 3]) == [0, 1, 2, 3]
    assert tfr.series_order([1, 2, 40, 5]) == [2, 3, 1, 0]


@pytest.mark.parametrize("D,F", [(2, 512), (16, 64)])
def test_wide_plain_versions_match_pallas_interpret(D, F):
    """Past the tiled kernels' widths, 2 blocks, B = 32, nf_tpu's probes
    injected: the plain versions against nf_tpu's Pallas kernels in
    interpret mode at test_plain_versions_match_pallas_interpret's
    tolerances."""
    jmodel, var, jspec, tmodel, tspec = _both(D, F, layers=2, seed=D + F)
    assert tfr.kernel_path(tspec) == "wide"
    packed = tfr.pack_resflow(tmodel.bijector, tspec)
    probes = nf_unbias_probes(32, D)
    x = normal(12 + D, (32, D), 1.5)
    jz, jld = jfr.fused_resflow_forward(jmodel.bijector, jspec, var, x, interpret=True)
    z, ld = tfr.fused_resflow_fwd_logdet_reference(tspec, packed, _t(x), probes)
    close(z, jz, 1e-5)
    close(ld, jld, 1e-4)
    jx, jldi = jfr.fused_resflow_inverse(jmodel.bijector, jspec, var, np.asarray(jz),
                                         interpret=True)
    xi, ldi = tfr.fused_resflow_solve_logdet_reference(tspec, packed, _t(jz), probes)
    close(xi, jx, 5e-4)
    close(ldi, jldi, 1e-3)
    jxs = jfr.fused_resflow_inverse_solve(jmodel.bijector, jspec, var, np.asarray(jz),
                                          interpret=True)
    close(tfr.fused_resflow_solve_reference(tspec, packed, _t(jz)), jxs, 5e-4)


@pytest.mark.parametrize("D", [2, 9, 16, 64, 400, 1024])
def test_every_width_has_a_plan_within_one_block(D):
    """Every (D, F) of the grid has a kernel and a plan within 232,448
    bytes a block: the tiled kernels (and the solve's warp kernel) up to
    F = 256 and D = 8, the wide kernel past, on clusters the card schedules
    (1, 2, 4 or 8 members, ACTIVE_CLUSTERS measured), at B = 1,000 and
    8,192; W2t's slab resident wherever the plan says so, the vectors in
    shared memory or device scratch."""
    for F in (32, 256, 512, 1024, 4096):
        spec = tfr.ResFlowSpec(n_repeats=2, dim=D, filters=F, n_iters=20, ftol=1e-6)
        assert tfr.covers(spec)
        if tfr.kernel_path(spec) == "tile":
            fp, dp = tfr.padded_width(F), tfr.padded_dim(D)
            assert tfr.smem_bytes(fp, dp) <= tfr.SMEM_LIMIT
            if tfr.solve_kernel(fp) == "warp":
                assert tfr.solve_smem_bytes(fp, dp) <= tfr.SMEM_LIMIT
            continue
        C = tfr.wide_cluster(F, D)
        assert C in tfr.CLUSTER_SIZES == (1, 2, 4, 8)
        for B in (1000, 8192):
            plan = tfr.wide_plan(F, D, B)
            geo = plan.geometry()
            assert plan.cluster == C and plan.smem_bytes <= tfr.SMEM_LIMIT == 232448
            assert plan.samples % 8 == 0 and plan.chunk % 32 == 0 and plan.kchunk % 16 == 0
            assert plan.part_smem or C == 1
            slab = 4 * (geo["Fs"] * geo["FP"] + 4)
            assert plan.w2_res == (plan.residency != "streamed")
            if plan.w2_res:
                assert slab <= plan.smem_bytes
            if not plan.vec_smem:
                assert plan.scratch_floats >= geo["vec_floats"]
    assert tfr.ACTIVE_CLUSTERS == {1: 132, 2: 66, 4: 30, 8: 15}
    assert tfr.wide_plan(512, 2, 1000).args() == [2, 16, 64, 128, 0, 1, 1, 1, 1]
    assert tfr.wide_plan(64, 16, 1000).args() == [1, 8, 32, 64, 1, 1, 1, 1, 1]
    assert tfr.wide_plan(512, 2, 1000, cluster=8).residency == "cluster"
    assert tfr.wide_plan(1024, 1024, 1000).residency == "streamed"


def test_wrapper_takes_plain_versions_on_cpu():
    tmodel = torch_model("resflow", 2, 3, 8)
    prog = tmodel.eval_program(tmodel.init(torch.Generator().manual_seed(0)))
    stack = prog.stack
    assert isinstance(stack, tfr.PackedResFlow) and stack.kernel is None
    x = torch.from_numpy(normal(3, (10, 2)))
    probes = tfr.draw_unbias_probes(10, 2, torch.Generator().manual_seed(4))
    before = dict(tfr.LAUNCHES)
    z, ld = tfr.fused_resflow(stack, x, "forward", probes)
    xs = tfr.fused_resflow(stack, z, "solve")
    assert tfr.LAUNCHES == before
    want = tfr.fused_resflow_fwd_logdet_reference(stack.spec, stack.packed, x, probes)
    close(z, want[0], 0.0)
    close(ld, want[1], 0.0)
    close(xs, x, 1e-4)
    with pytest.raises(ValueError, match="direction"):
        tfr.fused_resflow(stack, x, "sideways")
    with pytest.raises(ValueError, match="probes"):
        tfr.fused_resflow(stack, x, "inverse")
    with pytest.raises(ValueError, match="probes"):
        tfr.fused_resflow(stack, x[:5], "forward", probes)


def test_nf_tpu_probes_convert_to_the_ports_layout():
    V, thr, cap = jfr.draw_unbias_probes(16, 3)
    v, n_terms = nf_unbias_probes(16, 3)
    assert v.shape == (4, 16, 3) and n_terms.shape == (4,)
    close(v[2, 5], np.asarray(V)[:, 2, 5], 0.0)
    assert int(n_terms.max()) == int(np.asarray(cap)[0])
    assert jax.numpy.all(thr[0, :, 0] == np.asarray(n_terms, np.float32))
