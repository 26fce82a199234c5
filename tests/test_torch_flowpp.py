"""The port's Flow++ density serving path against nf_tpu's, on the CPU.

* the conditioner blocks (``GatedLinear``, ``LayerNormNet``, ``GatedAttn``
  at one token and at four), the logit-space mixture transform and
  ``MixLogAttnCoupling``: forward atol 2e-5; the Newton inverse atol 1e-4
  on x and 1e-3 on the log-det (two solves meet the root within XTOL);
* the fused Flow++ module: spec fields, ``pack_flowpp`` (atol 1e-6),
  ``fused_flowpp_reference`` against the Pallas kernel in interpret mode
  (forward atol 3e-5, inverse 5e-4 on x and 5e-3 on the log-det, as
  tests/test_pallas.py), and the kernel's own weight layout walked the way
  the CUDA kernel walks it, with its lane-group split (the LayerNorm and
  log-sum-exp reductions as 8 lanes' partials in the butterfly order) held
  at the card's tolerances;
* the whole slice at full depth (32 couplings, F = 32, K = 8, D = 2): the
  port's EvalProgram against nf_tpu's ``eval_program``, forward atol 1e-4,
  inverse 1e-3 on x (rtol 1e-4) and 5e-3 on the log-det.
"""
import jax
import numpy as np
import pytest
import torch
from _torch_parity import close, jax_model, normal, to_numpy, torch_model

from nf_tpu.core import Ctx
from nf_tpu.ops.pallas import fused_flowpp as jff
from nf_tpu_torch.ops.cuda import fused_flowpp as tff

ATOL = 2e-5
INV_X_ATOL, INV_LD_ATOL = 1e-4, 1e-3
EVAL = Ctx(rng=None, train=False)


def _t(a):
    return torch.tensor(np.asarray(a))


def _load(module, var):
    from nf_tpu_torch.convert import load_jax_variables
    load_jax_variables(module, to_numpy(var))
    return module.eval()


def _moved(var, seed, scale=0.3):
    """Every parameter moved off its init by seeded noise."""
    leaves, tree = jax.tree.flatten(var["params"])
    leaves = [np.asarray(l) + normal(seed + i, np.shape(l), scale)
              for i, l in enumerate(leaves)]
    return {"params": jax.tree.unflatten(tree, leaves), "state": var["state"]}


# --------------------------------------------------------------- modules
def test_gated_linear():
    from nf_tpu.nets.gated import GatedLinear as JGL
    from nf_tpu_torch.nets.gated import GatedLinear

    jg = JGL(8)
    var = jg.init(jax.random.PRNGKey(1))
    x = normal(1, (21, 8), 1.5)
    tg = _load(GatedLinear(8, device="cpu"), var)
    close(tg(_t(x)).detach(), jg.apply(var, x, EVAL)[0], ATOL)


@pytest.mark.parametrize("shape", [(8,), (2, 3, 4)])
def test_layer_norm_net(shape):
    from nf_tpu.nets.gated import LayerNormNet as JLN
    from nf_tpu_torch.nets.gated import LayerNormNet

    jl = JLN(shape)
    var = _moved(to_numpy(jl.init(jax.random.PRNGKey(2))), 3)
    x = normal(2, (5,) + shape, 2.0) + 0.7
    tl = _load(LayerNormNet(shape, device="cpu"), var)
    close(tl(_t(x)).detach(), jl.apply(var, x, EVAL)[0], ATOL)


def test_gated_attn_at_one_token():
    from nf_tpu.nets.gated import GatedAttn as JGA
    from nf_tpu_torch.nets.gated import GatedAttn

    ja = JGA((8,), 8)
    var = ja.init(jax.random.PRNGKey(4))
    x = normal(4, (13, 8))
    ta = _load(GatedAttn((8,), 8, device="cpu"), var)
    close(ta(_t(x)).detach(), ja.apply(var, x, EVAL)[0], ATOL)


def test_gated_attn_over_many_tokens_is_not_in_this_slice():
    """Attention over more than one token is ported (image Flow++): at
    (2, 2, 4) it matches nf_tpu; tests/test_torch_flowpp_image.py holds
    the image shapes."""
    from nf_tpu.nets.gated import GatedAttn as JGA
    from nf_tpu_torch.nets.gated import GatedAttn

    ja = JGA((2, 2, 4), 4)
    var = ja.init(jax.random.PRNGKey(5))
    x = normal(5, (3, 2, 2, 4))
    ta = _load(GatedAttn((2, 2, 4), 4, device="cpu"), var)
    close(ta(_t(x)).detach(), ja.apply(var, x, EVAL)[0], ATOL)
    with pytest.raises(ValueError, match="heads"):
        GatedAttn((6,), 6)


def _mixture(seed, B, N, K):
    logits = normal(seed, (B, N, K), 1.5)
    logpi = np.asarray(jax.nn.log_softmax(logits, axis=-1))
    return logpi, normal(seed + 1, (B, N, K), 2.0), normal(seed + 2, (B, N, K), 0.7)


def test_mix_log_cdf_logit_forward():
    from nf_tpu.bijectors import mixlogcdf as jm
    from nf_tpu_torch.bijectors import mixlogcdf as tm

    assert (tm.SPAN, tm.N_ITERS, tm.XTOL, tm.TINY) == (jm.SPAN, jm.N_ITERS, jm.XTOL, jm.TINY)
    logpi, mu, s = _mixture(5, 32, 3, 6)
    x = normal(8, (32, 3), 6.0)
    y, ld = tm.mix_log_cdf_logit_forward(_t(x), _t(logpi), _t(mu), _t(s))
    jy, jld = jm.mix_log_cdf_logit_forward(x, logpi, mu, s)
    close(y, jy, ATOL, 1e-6)
    close(ld, jld, ATOL, 1e-6)


def test_mix_log_cdf_logit_inverse_into_the_tails():
    from nf_tpu.bijectors import mixlogcdf as jm
    from nf_tpu_torch.bijectors import mixlogcdf as tm

    logpi, mu, s = _mixture(9, 40, 2, 5)
    y = np.linspace(-20.0, 20.0, 80, dtype=np.float32).reshape(40, 2)
    x, ld = tm.mix_log_cdf_logit_inverse(_t(y), _t(logpi), _t(mu), _t(s))
    jx, jld = jm.mix_log_cdf_logit_inverse(y, logpi, mu, s)
    close(x, jx, INV_X_ATOL, 1e-6)
    close(ld, jld, INV_LD_ATOL)
    yr, _ = tm.mix_log_cdf_logit_forward(x, _t(logpi), _t(mu), _t(s))
    close(yr, y, 1e-3, 1e-4)


@pytest.mark.parametrize("D", [2, 3])
@pytest.mark.parametrize("odd", [False, True])
def test_mixlog_attn_coupling(D, odd):
    from nf_tpu.bijectors.flowpp_coupling import MixLogAttnCoupling as JC
    from nf_tpu_torch.bijectors.flowpp_coupling import MixLogAttnCoupling

    jc = JC((D,), odd=odd, base_filters=8, n_mixtures=3)
    var = to_numpy(jc.init(jax.random.PRNGKey(6)))
    var["params"]["a_log_scale"] = np.float32([0.6])
    var["params"]["a_bias"] = np.float32([-0.2])
    tc = _load(MixLogAttnCoupling((D,), odd=odd, base_filters=8, n_mixtures=3,
                                  device="cpu"), var)
    x = normal(6 + D, (32, D), 1.5)
    with torch.no_grad():
        y, ld = tc(_t(x))
        jy, jld, _ = jc.forward(var, x, EVAL)
        close(y, jy, ATOL, 1e-6)
        close(ld, jld, ATOL, 1e-6)
        xr, ldi = tc.inverse(_t(jy))
        jx, jldi, _ = jc.inverse(var, jy, EVAL)
        close(xr, jx, INV_X_ATOL)
        close(ldi, jldi, INV_LD_ATOL)
        close(xr, x, INV_X_ATOL)


# ------------------------------------------------------- the fused module
def _both(F, layers=4, K=4, seed=0):
    jmodel, var = jax_model("flow++", 2, layers, F, seed=seed, mixtures=K)
    tmodel = torch_model("flow++", 2, layers, F, var, mixtures=K)
    jspec = jff.extract_flowpp_spec(jmodel.bijector, jmodel.dims)
    tspec = tff.extract_flowpp_spec(tmodel.bijector, tmodel.dims)
    return jmodel, var, jspec, tmodel, tspec


@pytest.mark.parametrize("F", [8, 32])
def test_spec_matches(F):
    _, _, jspec, tmodel, tspec = _both(F)
    assert jspec is not None and tspec is not None
    for field in ("kind", "n_repeats", "dim", "filters", "n_mixtures"):
        assert getattr(tspec, field) == getattr(jspec, field), field
    from nf_tpu_torch.ops.cuda.fused_stack import extract_stack_spec
    assert extract_stack_spec(tmodel.bijector, tmodel.dims) is None


@pytest.mark.parametrize("name,D", [("flow++", 3), ("realnvp", 2), ("glow", 2)])
def test_spec_rejects_nonmatching(name, D):
    from nf_tpu.config import NetworkConfig
    from nf_tpu.models import build_model

    jm = build_model(name, (D,), datatype="2d",
                     cfg=NetworkConfig(name=name, layers=4, mixtures=4))
    tm = torch_model(name, D, 4, 32)
    assert jff.extract_flowpp_spec(jm.bijector, jm.dims) is None
    assert tff.extract_flowpp_spec(tm.bijector, tm.dims) is None


@pytest.mark.parametrize("F", [8, 32])
def test_pack_flowpp_matches(F):
    jmodel, var, jspec, tmodel, tspec = _both(F)
    jpacked, jconst = jff.pack_flowpp(jmodel.bijector, jspec, var)
    tpacked, tconst = tff.pack_flowpp(tmodel.bijector, tspec)
    close(tconst, jconst, 1e-6)
    for parity in range(2):
        assert set(tpacked[parity]) == set(jpacked[parity])
        for key, arr in jpacked[parity].items():
            assert tuple(tpacked[parity][key].shape) == arr.shape, key
            close(tpacked[parity][key], arr, 1e-6)


@pytest.mark.parametrize("F", [8, 32])
def test_reference_matches_pallas_interpret(F):
    jmodel, var, jspec, tmodel, tspec = _both(F)
    x = normal(10, (64, 2))
    packed, const_ld = tff.pack_flowpp(tmodel.bijector, tspec)

    jz, jld = jff.fused_flowpp_forward(jmodel.bijector, jspec, var, x, interpret=True)
    z, ld = tff.fused_flowpp_reference(packed, const_ld, _t(x), "forward")
    close(z, jz, 3e-5)
    close(ld, jld, 3e-5, 1e-5)

    jy, jldi = jff.fused_flowpp_inverse(jmodel.bijector, jspec, var, np.asarray(jz),
                                        interpret=True)
    y, ldi = tff.fused_flowpp_reference(packed, const_ld, _t(jz), "inverse")
    close(y, jy, 5e-4)
    close(ldi, jldi, 5e-3, 1e-4)


def _walk_kernel_layout(kw, spec, x, inverse):
    """The CUDA kernel's loop in PyTorch, reading ``KernelWeights``' one
    block per coupling at the padded width FP and mixture count KP."""
    from nf_tpu_torch.bijectors.mixlogcdf import (mix_log_cdf_logit_forward,
                                                  mix_log_cdf_logit_inverse)

    lay = tff.Layout(kw.fp, kw.kp)
    fp, kp, hp, F, K = kw.fp, kw.kp, lay.hp, spec.filters, spec.n_mixtures
    elu, sig = torch.nn.functional.elu, torch.sigmoid

    def ln(h, g, b):
        mu = h[:, :F].mean(1, keepdim=True)
        var = ((h[:, :F] - mu) ** 2).mean(1, keepdim=True)
        return (h - mu) * torch.rsqrt(var + tff.LN_EPS) * g + b

    x = x.clone()
    ld = torch.zeros(x.shape[0])
    order = range(spec.n_repeats)
    for c in (reversed(order) if inverse else order):
        p, w = c % 2, kw.w[c]
        pre = (kw.prei if inverse else kw.pre)[c]
        if not inverse:
            x = (x - pre[:, 0]) * pre[:, 1]
        vec = w[lay.vec:lay.vec + 8 * fp].view(8, fp)
        h = x[:, 1 - p, None] * vec[0] + vec[1]
        u = torch.cat([elu(h), elu(-h)], 1) @ w[:2 * fp * fp].view(fp, 2 * fp).T + vec[2]
        h = ln(h + elu(u) * sig(elu(-u)), vec[3], vec[4])
        A = h @ w[lay.wq:lay.wo].view(fp, fp).T + vec[5]
        y = A @ w[lay.wo:lay.wh].view(2 * fp, fp).T + w[lay.bo:lay.bh]
        h = ln(h + y[:, :fp] * sig(y[:, fp:]), vec[6], vec[7])
        raw = h @ w[lay.wh:lay.vec].view(hp, fp).T + w[lay.bh:lay.size]
        a = torch.tanh(raw[:, 0]) * kw.gb[c, 0] + kw.gb[c, 1]
        logpi = torch.log_softmax(raw[:, 2:2 + K], 1)
        mu, s = raw[:, 2 + kp:2 + kp + K], raw[:, 2 + 2 * kp:2 + 2 * kp + K]
        x = x.clone()
        if inverse:
            z, ldm = mix_log_cdf_logit_inverse((x[:, p] - raw[:, 1]) * torch.exp(-a),
                                               logpi, mu, s)
            x[:, p] = z
            ld = ld - a + ldm
            x = x * pre[:, 1] + pre[:, 0]
        else:
            z, ldm = mix_log_cdf_logit_forward(x[:, p], logpi, mu, s)
            x[:, p] = z * torch.exp(a) + raw[:, 1]
            ld = ld + ldm + a
    return x, ld


@pytest.mark.parametrize("F,K", [(8, 4), (20, 3), (32, 12)])
def test_kernel_layout_matches_reference(F, K):
    tmodel = torch_model("flow++", 2, 4, F, _both(F, K=K, seed=1)[1], mixtures=K)
    spec = tff.extract_flowpp_spec(tmodel.bijector, tmodel.dims)
    packed, const_ld = tff.pack_flowpp(tmodel.bijector, spec)
    kw = tff.kernel_weights(spec, packed)
    assert (kw.fp, kw.kp) == (tff.padded_width(F), tff.padded_mixtures(K))
    assert kw.w.shape == (spec.n_repeats, tff.Layout(kw.fp, kw.kp).size)
    x = torch.from_numpy(normal(20, (33, 2)))
    for direction in ("forward", "inverse"):
        want = tff.fused_flowpp_reference(packed, const_ld, x, direction)
        got = _walk_kernel_layout(kw, spec, x, direction == "inverse")
        sign = -1.0 if direction == "inverse" else 1.0
        close(got[0], want[0], ATOL, 1e-6)
        close(got[1] + sign * const_ld, want[1], ATOL, 1e-6)


def _butterfly(partials, op):
    """The kernel's reduction over a sample's lanes: partials (B, G) combined
    with the lane xor 1, then 2, then 4; every lane ends with the same
    value (each step is commutative), returned as lane 0's."""
    for m in (1, 2, 4):
        partials = op(partials, partials[:, torch.arange(tff.LANES) ^ m])
    return partials[:, 0]


def _lane_partials(t, valid):
    """(B, N) values of N = n G features or components, lane j holding
    j + i G: each lane's partial sum over its valid ones, in i order."""
    G = tff.LANES
    t = torch.where(valid, t, torch.zeros_like(t)).view(t.shape[0], -1, G)
    acc = torch.zeros(t.shape[0], G)
    for i in range(t.shape[1]):
        acc = acc + t[:, i]
    return acc


def _lane_max(t, valid):
    G = tff.LANES
    t = torch.where(valid, t, torch.full_like(t, -float("inf")))
    return t.view(t.shape[0], -1, G).amax(1)


def _walk_lane_groups(kw, spec, x, inverse):
    """csrc/fused_flowpp.cu's lane-group split in PyTorch: each dense layer
    by output feature (a whole dot product per output), the LayerNorm
    statistics, the head's log-softmax and the mixture's three
    log-sum-exps as lane partials reduced in the butterfly order, the
    Newton trips taken per sample with its early exit."""
    from nf_tpu_torch.bijectors.mixlogcdf import N_ITERS, SPAN, TINY, XTOL

    lay = tff.Layout(kw.fp, kw.kp)
    fp, kp, hp, F, K = kw.fp, kw.kp, lay.hp, spec.filters, spec.n_mixtures
    elu, sig = torch.nn.functional.elu, torch.sigmoid
    feat = (torch.arange(fp) < F)[None].expand(x.shape[0], fp)
    comp = (torch.arange(kp) < K)[None].expand(x.shape[0], kp)

    def ln(h, g, b):
        mean = _butterfly(_lane_partials(h, feat), torch.add)[:, None] / F
        d = h - mean
        var = _butterfly(_lane_partials(d * d, feat), torch.add)[:, None] / F
        return d * torch.rsqrt(var + tff.LN_EPS) * g + b

    def lse(t):
        m = _butterfly(_lane_max(t, comp), torch.maximum)[:, None]
        return m[:, 0] + torch.log(_butterfly(_lane_partials(torch.exp(t - m), comp), torch.add))

    def parts(xk, logpi, mu, s):
        z = (xk[:, None] - mu) * torch.exp(-s)
        t = torch.log1p(torch.exp(-z.abs()))
        return (lse(logpi + (torch.clamp(z, max=0.0) - t)),
                lse(logpi + (-torch.clamp(z, min=0.0) - t)),
                lse(logpi + (z - s - 2.0 * (torch.clamp(z, min=0.0) + t))))

    def newton(t, logpi, mu, s):
        xk = torch.zeros_like(t)
        lo, hi = torch.full_like(t, -SPAN), torch.full_like(t, SPAN)
        dxold = torch.full_like(t, 2.0 * SPAN)
        active = torch.ones_like(t, dtype=torch.bool)
        for _ in range(N_ITERS):
            u, v, lpdf = parts(xk, logpi, mu, s)
            f = (u - v) - t
            lo = torch.where(f < 0, xk, lo)
            hi = torch.where(f >= 0, xk, hi)
            df = torch.clamp(torch.exp(lpdf - u - v), min=TINY)
            dx = f / df
            xn = xk - dx
            bis = ((xn <= lo) | (xn >= hi) | (torch.abs(2.0 * f) > torch.abs(dxold * df))
                   | ~torch.isfinite(xn))
            active = active & ~((torch.abs(dx) <= XTOL) | ((hi - lo) <= XTOL))
            xk = torch.where(active, torch.where(bis, (lo + hi) * 0.5, xn), xk)
            dxold = torch.where(active, torch.where(bis, (hi - lo) * 0.5, dx), dxold)
        u, v, lpdf = parts(xk, logpi, mu, s)
        return xk, lpdf - u - v

    x = x.clone()
    ld = torch.zeros(x.shape[0])
    order = range(spec.n_repeats)
    for c in (reversed(order) if inverse else order):
        p, w = c % 2, kw.w[c]
        pre = (kw.prei if inverse else kw.pre)[c]
        if not inverse:
            x = (x - pre[:, 0]) * pre[:, 1]
        vec = w[lay.vec:lay.vec + 8 * fp].view(8, fp)
        h = x[:, 1 - p, None] * vec[0] + vec[1]
        u = torch.cat([elu(h), elu(-h)], 1) @ w[:2 * fp * fp].view(fp, 2 * fp).T + vec[2]
        h = ln(h + elu(u) * sig(elu(-u)), vec[3], vec[4])
        A = h @ w[lay.wq:lay.wo].view(fp, fp).T + vec[5]
        y = A @ w[lay.wo:lay.wh].view(2 * fp, fp).T + w[lay.bo:lay.bh]
        h = ln(h + y[:, :fp] * sig(y[:, fp:]), vec[6], vec[7])
        raw = h @ w[lay.wh:lay.vec].view(hp, fp).T + w[lay.bh:lay.size]
        a = torch.tanh(raw[:, 0]) * kw.gb[c, 0] + kw.gb[c, 1]
        lp = raw[:, 2:2 + kp]
        logpi = torch.where(comp, lp - lse(lp)[:, None], torch.full_like(lp, -float("inf")))
        mu, s = raw[:, 2 + kp:2 + 2 * kp], raw[:, 2 + 2 * kp:2 + 3 * kp]
        x = x.clone()
        if inverse:
            z, ldm = newton((x[:, p] - raw[:, 1]) * torch.exp(-a), logpi, mu, s)
            x[:, p] = z
            ld = ld - a - ldm
            x = x * pre[:, 1] + pre[:, 0]
        else:
            u_, v_, lpdf = parts(x[:, p], logpi, mu, s)
            x[:, p] = (u_ - v_) * torch.exp(a) + raw[:, 1]
            ld = ld + (lpdf - u_ - v_) + a
    return x, ld


@pytest.mark.parametrize("F,K", [(8, 4), (8, 8), (20, 4), (32, 8), (128, 4), (128, 8),
                                 (32, 12)])
def test_lane_group_walk_matches_reference(F, K):
    """The lane-group split at FP = 8, 32 and 128 (and KP = 32 at K = 12)
    against the plain version, at the card's tolerances: z 1e-4, log-det
    1e-3; inverse x 1e-2, log-det 5e-3."""
    tmodel = torch_model("flow++", 2, 4, F, _both(F, K=K, seed=2)[1], mixtures=K)
    spec = tff.extract_flowpp_spec(tmodel.bijector, tmodel.dims)
    packed, const_ld = tff.pack_flowpp(tmodel.bijector, spec)
    kw = tff.kernel_weights(spec, packed)
    assert kw.fp % tff.LANES == 0 and kw.kp % tff.LANES == 0
    x = torch.from_numpy(normal(21, (33, 2), 1.5))
    z, ldz = tff.fused_flowpp_reference(packed, const_ld, x, "forward")
    got = _walk_lane_groups(kw, spec, x, False)
    close(got[0], z, 1e-4, 1e-4)
    close(got[1] + const_ld, ldz, 1e-3)
    want = tff.fused_flowpp_reference(packed, const_ld, z, "inverse")
    got = _walk_lane_groups(kw, spec, z, True)
    close(got[0], want[0], 1e-2)
    close(got[1] - const_ld, want[1], 5e-3)


def test_kernel_tilings():
    """The (FP, KP) tilings the kernel is built for, and which of them
    stage their weights in shared memory, as csrc/fused_flowpp.cu lists:
    32 samples' rows of 3 FP + 4 floats and two coupling blocks with every
    matrix row padded by 4 floats."""
    table = {(fp, kp): tff.staged(fp, kp) for fp in tff.WIDTHS for kp in tff.MIXTURES}
    assert table == {(8, 8): True, (8, 32): True, (16, 8): True, (16, 32): True,
                     (32, 8): True, (32, 32): True, (64, 8): True, (64, 32): False,
                     (128, 8): False, (128, 32): False}
    for (fp, kp), st in table.items():
        assert tff.smem_bytes(fp, kp, st) <= tff.SMEM_LIMIT
    assert tff.Layout(32, 8).size % 4 == 0 and tff.Layout(8, 32).size % 4 == 0
    assert tff.smem_bytes(32, 8, True) == 4 * (32 * 100 + 2 * (6364 + 4 * (4 * 32 + 28)))


def test_wrapper_takes_plain_version_on_cpu():
    tmodel = torch_model("flow++", 2, 4, 8)
    prog = tmodel.eval_program(tmodel.init(torch.Generator().manual_seed(0)))
    stack = prog.stack
    assert isinstance(stack, tff.PackedFlowpp) and stack.kernel is None
    x = torch.from_numpy(normal(3, (10, 2)))
    before = dict(tff.LAUNCHES)
    z, ld = tff.fused_flowpp(stack, x, "forward")
    assert tff.LAUNCHES == before
    want = tff.fused_flowpp_reference(stack.packed, stack.const_ld, x, "forward")
    close(z, want[0], 0.0)
    close(ld, want[1], 0.0)
    with pytest.raises(ValueError, match="direction"):
        tff.fused_flowpp(stack, x, "sideways")


# ------------------------------------------------------ the slice, full depth
@pytest.fixture(scope="module")
def full_depth():
    jmodel, var = jax_model("flow++", 2, 32, 32, seed=3, batch=256, mixtures=8)
    return jmodel, var, torch_model("flow++", 2, 32, 32, var, mixtures=8)


def test_eval_program_matches_nf_tpu_full_depth(full_depth):
    jmodel, var, tmodel = full_depth
    jprog = jmodel.eval_program(var)
    prog = tmodel.eval_program()
    assert isinstance(prog.stack, tff.PackedFlowpp)
    x = normal(7, (256, 2))

    jz, jld = jprog.forward(x)
    z, ld = prog.forward(_t(x))
    close(z, jz, 1e-4, 1e-5)
    close(ld, jld, 1e-4, 1e-5)
    close(prog.log_prob(_t(x)), jprog.log_prob(x), 1e-4, 1e-5)

    zin = normal(8, (256, 2))
    jy, jldi = jprog.inverse(zin)
    y, ldi = prog.inverse(_t(zin))
    close(y, jy, 1e-3, 1e-4)
    close(ldi, jldi, 5e-3)


def test_eval_program_sample_is_inverse_of_its_draw(full_depth):
    from nf_tpu_torch.ops.math import standard_normal_logprob

    *_, tmodel = full_depth
    prog = tmodel.eval_program()
    y, log_py = prog.sample(64, torch.Generator().manual_seed(11))
    z = torch.randn(64, 2, generator=torch.Generator().manual_seed(11))
    y2, ldi = prog.inverse(z)
    close(y, y2, 0.0)
    close(log_py, standard_normal_logprob(z) - ldi, 0.0)
    assert torch.isfinite(y).all() and torch.isfinite(log_py).all()


def test_eval_program_matches_eager_chain_and_round_trips(full_depth):
    *_, tmodel = full_depth
    prog = tmodel.eval_program()
    x = torch.from_numpy(normal(9, (128, 2)))
    with torch.no_grad():
        z, ld = tmodel(x)
        zp, ldp = prog.forward(x)
        close(zp, z, 1e-4, 1e-5)
        close(ldp, ld, 1e-4, 1e-5)
        xr, ldi = prog.inverse(zp)
        close(xr, x, 1e-3)
        close(ldi, -ldp, 5e-3)


def test_image_mode_not_in_this_slice():
    """The image tier is ported: at 8x8x1 the builder emits Logit and one
    final checkerboard block of layers + 1 x [ActNorm, InvertibleConv1x1,
    MixLogAttnCoupling], and the model inverts itself
    (tests/test_torch_flowpp_image_model.py holds it to nf_tpu)."""
    from nf_tpu_torch.bijectors.conv1x1 import InvertibleConv1x1
    from nf_tpu_torch.bijectors.elementwise import Logit
    from nf_tpu_torch.bijectors.flowpp_coupling import MixLogAttnCoupling
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.models import build_model

    model = build_model("flow++", (8, 8, 1), "image",
                        NetworkConfig(layers=2, base_filters=8, mixtures=2), device="cpu")
    layers = list(model.bijector.layers)
    assert isinstance(layers[0], Logit) and len(layers) == 1 + 3 * 3
    assert all(isinstance(c, InvertibleConv1x1) for c in layers[2::3])
    assert all(isinstance(c, MixLogAttnCoupling) and c.masking == "checkerboard"
               for c in layers[3::3])
    prog = model.eval_program(model.init(torch.Generator().manual_seed(0)))
    x = torch.rand(5, 8, 8, 1, generator=torch.Generator().manual_seed(1)) * 0.9 + 0.05
    z, ld = prog.forward(x)
    xr, ldi = prog.inverse(z)
    close(xr, x, 1e-4)
    close(ldi, -ld, 1e-3)
