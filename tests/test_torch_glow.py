"""The port's Glow density serving path against nf_tpu's, on the CPU.

* ``ActNorm`` and ``InvertibleConv1x1``, forward and inverse, atol 2e-5;
* the Glow variant of the fused stack: spec fields, ``pack_stack``
  (``pre`` / ``prei`` / ``mix`` / ``mixi`` / ... / const_ld, atol 1e-6),
  ``fused_stack_reference`` against the Pallas kernel in interpret mode
  (atol 2e-5, as tests/test_pallas.py), and the kernel's own weight layout
  walked the way the CUDA kernel walks it;
* the whole slice at full depth (32 couplings, F = 32, D = 2): the port's
  EvalProgram against nf_tpu's ``eval_program``, atol 1e-4 (f32 sums in
  another order, compounded through 32 couplings).

nf_tpu runs its ActNorm data-dependent init (which also moves the
conditioners' batch-norm statistics) and the variables are carried across.
"""
import jax
import numpy as np
import pytest
import torch
from _torch_parity import close, jax_model, normal, to_numpy, torch_model

from nf_tpu.core import Ctx
from nf_tpu.ops.pallas import fused_stack as jfs
from nf_tpu_torch.ops.cuda import fused_stack as tfs

ATOL = 2e-5
FULL_ATOL = 1e-4
EVAL = Ctx(rng=None, train=False)
SIZES = [(2, 8), (2, 32), (3, 8), (3, 32)]   # (D, F), layers = 4


def _t(a):
    return torch.tensor(np.asarray(a))


def _both(D, F, layers=4, seed=0):
    jmodel, var = jax_model("glow", D, layers, F, seed=seed)
    tmodel = torch_model("glow", D, layers, F, var)
    jspec = jfs.extract_stack_spec(jmodel.bijector, jmodel.dims)
    tspec = tfs.extract_stack_spec(tmodel.bijector, tmodel.dims)
    return jmodel, var, jspec, tmodel, tspec


# --------------------------------------------------------------- modules
@pytest.mark.parametrize("D", [2, 3])
def test_actnorm(D):
    from nf_tpu.bijectors.norm import ActNorm as JActNorm
    from nf_tpu_torch.bijectors.norm import ActNorm
    from nf_tpu_torch.convert import load_jax_variables

    jn = JActNorm(D)
    var = jn.init(jax.random.PRNGKey(D))
    var = {"params": {"log_scale": normal(D, (D,), 0.4), "bias": normal(D + 1, (D,))},
           "state": {"initialized": np.True_}}
    tn = ActNorm(D, device="cpu")
    load_jax_variables(tn, to_numpy(var))
    assert bool(tn.initialized)
    x = normal(20 + D, (17, D), 1.5)
    y, ld = tn(_t(x))
    jy, jld, _ = jn.forward(var, x, EVAL)
    close(y.detach(), jy, ATOL)
    close(ld.detach(), jld, ATOL)
    xr, ldi = tn.inverse(y)
    jx, jldi, _ = jn.inverse(var, jy, EVAL)
    close(xr.detach(), jx, ATOL)
    close(ldi.detach(), jldi, ATOL)


@pytest.mark.parametrize("D", [2, 3])
def test_invertible_conv1x1(D):
    from nf_tpu.bijectors.conv1x1 import InvertibleConv1x1 as JConv
    from nf_tpu_torch.bijectors.conv1x1 import InvertibleConv1x1
    from nf_tpu_torch.convert import load_jax_variables

    jc = JConv(D)
    var = to_numpy(jc.init(jax.random.PRNGKey(10 + D)))
    # move the learned factors off their init; L arrives whole from the LU
    p = var["params"]
    var = {"params": {"L": p["L"] + np.tril(normal(1, (D, D), 0.2), -1) + np.triu(normal(2, (D, D)), 1),
                      "U": p["U"] + np.triu(normal(3, (D, D), 0.2), 1),
                      "log_s": p["log_s"] + normal(4, (D,), 0.2)},
           "state": var["state"]}
    tc = InvertibleConv1x1(D, device="cpu")
    load_jax_variables(tc, var)
    x = normal(30 + D, (19, D))
    with torch.no_grad():
        y, ld = tc(_t(x))
        jy, jld, _ = jc.forward(var, x, EVAL)
        close(y, jy, ATOL)
        close(ld, jld, ATOL)
        xr, ldi = tc.inverse(y)
        jx, jldi, _ = jc.inverse(var, jy, EVAL)
        close(xr, jx, ATOL)
        close(ldi, jldi, ATOL)
        close(xr, x, 1e-5)


def test_conv1x1_init_is_a_plu_of_an_orthogonal_matrix():
    from nf_tpu_torch.bijectors.conv1x1 import InvertibleConv1x1

    tc = InvertibleConv1x1(4, device="cpu")
    tc.init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        W = tc.weight()
        close(W @ W.T, np.eye(4), 1e-5)
        P, L, U = tc.factors()
        close(P.sum(0), np.ones(4), 0.0)
        close(P.sum(1), np.ones(4), 0.0)
        close(torch.diagonal(L), np.ones(4), 0.0)
        close(tc.sign_s.abs(), np.ones(4), 0.0)
        close(tc.log_s.sum(), 0.0, 1e-5)           # |det W| = 1


# --------------------------------------------------- the fused stack, Glow
@pytest.mark.parametrize("D,F", SIZES)
def test_spec_matches(D, F):
    _, _, jspec, _, tspec = _both(D, F)
    assert jspec is not None and tspec is not None
    assert tspec.has_mix and tspec.norm_kind == "actnorm"
    for field in ("n_repeats", "dim", "filters", "has_mix", "norm_kind", "halves"):
        assert getattr(tspec, field) == getattr(jspec, field), field


@pytest.mark.parametrize("D,F", SIZES)
def test_pack_stack_matches(D, F):
    jmodel, var, jspec, tmodel, tspec = _both(D, F)
    jpacked, jconst = jfs.pack_stack(jmodel.bijector, jspec, var)
    tpacked, tconst = tfs.pack_stack(tmodel.bijector, tspec)
    close(tconst, jconst, 1e-6)
    for parity in range(2):
        assert set(tpacked[parity]) == set(jpacked[parity])
        assert {"mix", "mixi"} <= set(tpacked[parity])
        for key, arr in jpacked[parity].items():
            assert tuple(tpacked[parity][key].shape) == arr.shape, key
            close(tpacked[parity][key], arr, 1e-6)


@pytest.mark.parametrize("D,F", SIZES)
def test_reference_matches_pallas_interpret(D, F):
    jmodel, var, jspec, tmodel, tspec = _both(D, F)
    x = normal(10 + D, (64, D))
    packed, const_ld = tfs.pack_stack(tmodel.bijector, tspec)

    jz, jld = jfs.fused_stack_forward(jmodel.bijector, jspec, var, x, interpret=True)
    z, ld = tfs.fused_stack_reference(packed, const_ld, torch.from_numpy(x), "forward")
    close(z, jz, ATOL)
    close(ld, jld, ATOL)

    jy, jldi = jfs.fused_stack_inverse(jmodel.bijector, jspec, var, np.asarray(jz),
                                       interpret=True)
    y, ldi = tfs.fused_stack_reference(packed, const_ld, _t(jz), "inverse")
    close(y, jy, ATOL)
    close(ldi, jldi, ATOL)


def _walk_kernel_layout(kw, spec, const_ld, x, inverse):
    """The FFMA kernel's loop in PyTorch, reading ``FfmaWeights`` at the
    padded width, with the mix applied per sample after the norm (forward)
    and before the un-norm (inverse); the tensor-core kernel's layout is
    walked in tests/test_torch_fused_stack.py."""
    B, D = x.shape
    half = (D + 1) // 2
    x = x.clone()
    ld = torch.zeros(B)
    order = range(spec.n_repeats)
    for c in (reversed(order) if inverse else order):
        p = c % 2
        n_out, n_in = (D + 1 - p) // 2, (D + p) // 2
        pre = (kw.prei if inverse else kw.pre)[c]
        mix = (kw.mixi if inverse else kw.mix)[c]
        if not inverse:
            x = ((x - pre[:, 0]) * pre[:, 1]) @ mix.T
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
            x = (x @ mix.T) * pre[:, 1] + pre[:, 0]
        else:
            x[:, rows] = x[:, rows] * torch.exp(s) + t
            ld = ld + s.sum(1)
    return x, ld + (-const_ld if inverse else const_ld)


@pytest.mark.parametrize("D,F", [(2, 8), (3, 20), (5, 32)])
def test_kernel_layout_matches_reference(D, F):
    tmodel = torch_model("glow", D, 4, F, jax_model("glow", D, 4, F, seed=1)[1])
    spec = tfs.extract_stack_spec(tmodel.bijector, tmodel.dims)
    packed, const_ld = tfs.pack_stack(tmodel.bijector, spec)
    kw = tfs.ffma_weights(spec, packed)
    assert kw.mix.shape == kw.mixi.shape == (spec.n_repeats, D, D)
    x = torch.from_numpy(normal(20 + D, (33, D)))
    for direction in ("forward", "inverse"):
        want = tfs.fused_stack_reference(packed, const_ld, x, direction)
        got = _walk_kernel_layout(kw, spec, const_ld, x, direction == "inverse")
        close(got[0], want[0], ATOL)
        close(got[1], want[1], ATOL)


def test_smem_budget_covers_the_mix():
    for fp, (S, _) in tfs.TILES.items():
        assert tfs.smem_bytes(fp, S, 3, True) <= tfs.SMEM_LIMIT
        assert tfs.smem_bytes(fp, S, 3, True) >= tfs.smem_bytes(fp, S, 3, False)


def test_launch_names_per_variant():
    glow = torch_model("glow", 2, 2, 8)
    realnvp = torch_model("realnvp", 2, 2, 8)
    gspec = tfs.extract_stack_spec(glow.bijector, glow.dims)
    rspec = tfs.extract_stack_spec(realnvp.bijector, realnvp.dims)
    assert tfs.launch_name(gspec, False) == "fused_stack_glow_fwd"
    assert tfs.launch_name(gspec, True) == "fused_stack_glow_inv"
    assert tfs.launch_name(rspec, False) == "fused_stack_fwd"
    assert set(tfs.LAUNCHES) == {"fused_stack_fwd", "fused_stack_inv",
                                 "fused_stack_glow_fwd", "fused_stack_glow_inv"}


# ------------------------------------------------------ the slice, full depth
@pytest.fixture(scope="module")
def full_depth():
    jmodel, var = jax_model("glow", 2, 32, 32, seed=3, batch=256)
    return jmodel, var, torch_model("glow", 2, 32, 32, var)


def test_eval_program_matches_nf_tpu_full_depth(full_depth):
    jmodel, var, tmodel = full_depth
    jprog = jmodel.eval_program(var)
    prog = tmodel.eval_program()
    assert isinstance(prog.stack, tfs.PackedStack) and prog.stack.spec.has_mix
    x = normal(7, (256, 2))

    jz, jld = jprog.forward(x)
    z, ld = prog.forward(_t(x))
    close(z, jz, FULL_ATOL)
    close(ld, jld, FULL_ATOL)
    close(prog.log_prob(_t(x)), jprog.log_prob(x), FULL_ATOL)

    zin = normal(8, (256, 2))
    jy, jldi = jprog.inverse(zin)
    y, ldi = prog.inverse(_t(zin))
    close(y, jy, FULL_ATOL)
    close(ldi, jldi, FULL_ATOL)


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


def test_eval_program_matches_eager_chain(full_depth):
    *_, tmodel = full_depth
    prog = tmodel.eval_program()
    x = torch.from_numpy(normal(9, (128, 2)))
    with torch.no_grad():
        z, ld = tmodel(x)
        zp, ldp = prog.forward(x)
        close(zp, z, FULL_ATOL)
        close(ldp, ld, FULL_ATOL)
        xr, ldi = tmodel.inverse(z)
        close(prog.inverse(z)[0], xr, FULL_ATOL)
        close(prog.inverse(z)[1], ldi, FULL_ATOL)


def test_image_mode_not_in_this_slice():
    """The image tier is ported: at 8x8x1 the builder emits Logit and one
    final checkerboard block of layers + 1 [ActNorm, InvertibleConv1x1,
    AffineCoupling] and no squeeze, and the model inverts itself
    (tests/test_torch_glow_image.py holds the image model to nf_tpu)."""
    from nf_tpu_torch.bijectors.conv1x1 import InvertibleConv1x1
    from nf_tpu_torch.bijectors.coupling import AffineCoupling
    from nf_tpu_torch.bijectors.elementwise import Logit
    from nf_tpu_torch.bijectors.norm import ActNorm
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.models import build_model

    model = build_model("glow", (8, 8, 1), "image",
                        NetworkConfig(name="glow", layers=2, base_filters=8), device="cpu")
    layers = list(model.bijector.layers)
    assert isinstance(layers[0], Logit) and len(layers) == 1 + 3 * 3
    assert [type(l) for l in layers[1:4]] == [ActNorm, InvertibleConv1x1, AffineCoupling]
    assert all(c.masking == "checkerboard" for c in layers[3::3])
    prog = model.eval_program(model.init(torch.Generator().manual_seed(0)))
    x = torch.rand(5, 8, 8, 1, generator=torch.Generator().manual_seed(1)) * 0.9 + 0.05
    z, ld = prog.forward(x)
    xr, ldi = prog.inverse(z)
    close(xr, x, 1e-5)
    close(ldi, -ld, 1e-3)
