"""The port's RealNVP image tier against nf_tpu, on the CPU.

Per module, atol 2e-5 (f32 sums in another order): the NHWC squeeze ops,
``Logit``, ``Conv2d``, ``ResBlock2d`` / ``ConvNet``, the image
``AffineCoupling``, and the train modes of ``BatchNorm`` / ``BatchNormNet``
with ``ActNorm.dd_init``.  Inputs are kept small where a log-det sums many
terms, so that its f32 rounding stays under the tolerance.

The whole image RealNVP at 16x16x1, layers = 1, base_filters = 8 (four
couplings, each half 128 wide, so each one crosses the coupling kernel's
gate), after nf_tpu's data-dependent init and three train-mode passes:
atol 1e-4 on z and x.  The log-dets and log p atol 3e-4: each is a sum of
256 log-derivative terms near 1.7 (|ld| near 450, where f32's spacing is
3e-5) taken in another order, and log p the difference of two such sums
(observed up to 1.2e-4).
"""
import jax
import numpy as np
import pytest
import torch
from _torch_parity import close, jax_image_model, normal, to_numpy, torch_image_model, uniform

from nf_tpu.core import Ctx

ATOL = 2e-5
EVAL = Ctx(rng=None, train=False)
TRAIN = Ctx(rng=None, train=True)
NOVAR = {"params": {}, "state": {}}


def _t(a):
    return torch.from_numpy(np.array(a))


def _load(module, var):
    from nf_tpu_torch.convert import load_jax_variables
    load_jax_variables(module, to_numpy(var))
    return module.eval()


@pytest.mark.parametrize("odd", [False, True])
@pytest.mark.parametrize("kind", ["checker", "channel", "squeeze"])
def test_squeeze_ops(kind, odd):
    from nf_tpu.ops import squeeze as jsq
    from nf_tpu_torch.ops import squeeze as tsq

    split, merge = {"checker": ("checker_split", "checker_merge"),
                    "channel": ("channel_split", "channel_merge"),
                    "squeeze": ("squeeze2d", "unsqueeze2d")}[kind]
    z = normal(1, (3, 6, 4, 5))
    a, b = getattr(tsq, split)(_t(z), odd)
    ja, jb = getattr(jsq, split)(z, odd)
    close(a, ja, 0.0)
    close(b, jb, 0.0)
    close(getattr(tsq, merge)(a, b, odd), z, 0.0)
    close(getattr(tsq, merge)(_t(ja), _t(jb), odd), getattr(jsq, merge)(ja, jb, odd), 0.0)


@pytest.mark.parametrize("odd", [False, True])
def test_squeeze_bijectors(odd):
    from nf_tpu.bijectors.squeeze import Squeeze2d as JS, Unsqueeze2d as JU
    from nf_tpu_torch.bijectors.squeeze import Squeeze2d, Unsqueeze2d

    z = normal(2, (2, 4, 6, 3))
    y, ld = Squeeze2d(odd)(_t(z))
    jy, jld, _ = JS(odd).forward(NOVAR, z, EVAL)
    close(y, jy, 0.0)
    close(ld, jld, 0.0)
    close(Squeeze2d(odd).inverse(y)[0], z, 0.0)
    u, _ = Unsqueeze2d(odd)(y)
    close(u, JU(odd).forward(NOVAR, jy, EVAL)[0], 0.0)
    close(Unsqueeze2d(odd).inverse(u)[0], y, 0.0)


@pytest.mark.parametrize("compress", [True, False])
def test_logit(compress):
    from nf_tpu.bijectors.elementwise import Logit as JL
    from nf_tpu_torch.bijectors.elementwise import Logit

    x = uniform(3, (6, 4, 4, 2), 0.0, 1.0)
    x[0, 0, 0, 0] = 0.002        # inside the clamp when compress=False
    tl, jl = Logit(0.01, compress), JL(0.01, compress)
    y, ld = tl(_t(x))
    jy, jld, _ = jl.forward(NOVAR, x, EVAL)
    close(y, jy, ATOL)
    close(ld, jld, ATOL)
    xr, ldi = tl.inverse(_t(jy))
    jx, jldi, _ = jl.inverse(NOVAR, jy, EVAL)
    close(xr, jx, ATOL)
    close(ldi, jldi, ATOL)


@pytest.mark.parametrize("weight_norm", [True, False])
@pytest.mark.parametrize("k", [3, 1])
def test_conv2d(k, weight_norm):
    from nf_tpu.nets.layers import Conv2d as JC
    from nf_tpu_torch.nets.layers import Conv2d

    jc = JC(3, 5, k, weight_norm=weight_norm)
    var = jc.init(jax.random.PRNGKey(k))
    x = normal(4, (2, 6, 5, 3))
    tc = _load(Conv2d(3, 5, k, weight_norm=weight_norm, device="cpu"), var)
    y = tc(_t(x)).detach()
    assert y.shape == (2, 6, 5, 5)
    close(y, jc.apply(var, x, EVAL)[0], ATOL)


def test_conv2d_init_keeps_nf_tpus_weight_norm_axis():
    """The port's own init: one norm per (input channel, tap), over out."""
    from nf_tpu_torch.nets.layers import Conv2d

    c = Conv2d(4, 6, 3, device="cpu")
    c.init(torch.Generator().manual_seed(0))
    assert c.g.shape == (4, 3, 3)
    close(torch.linalg.vector_norm(c.v, dim=0).detach(), np.ones((4, 3, 3)), 1e-4)
    close(torch.linalg.vector_norm(c.weight(), dim=0).detach(), c.g.detach(), 1e-5)


@pytest.mark.parametrize("in_c,out_c", [(6, 6), (3, 5)])
def test_resblock2d(in_c, out_c):
    from nf_tpu.nets.conditioners import ResBlock2d as JRB
    from nf_tpu_torch.nets.conditioners import ResBlock2d

    jr = JRB(in_c, out_c)
    var = jr.init(jax.random.PRNGKey(6))
    x = normal(6, (4, 5, 5, in_c))
    _, st = jr.apply(var, x - 0.3, TRAIN)
    var = {"params": var["params"], "state": st}
    tr = _load(ResBlock2d(in_c, out_c, device="cpu"), var)
    assert (tr.bridge is None) == (in_c == out_c)
    close(tr(_t(x)).detach(), jr.apply(var, x, EVAL)[0], ATOL)


def test_convnet():
    from nf_tpu.nets.conditioners import ConvNet as JCN
    from nf_tpu_torch.nets.conditioners import ConvNet

    jn = JCN(2, 4, base_filters=8)
    var = jn.init(jax.random.PRNGKey(7))
    x = normal(7, (4, 6, 6, 2))
    _, st = jn.apply(var, x * 2.0 + 1.0, TRAIN)
    var = {"params": var["params"], "state": st}
    tn = _load(ConvNet(2, 4, base_filters=8, device="cpu"), var)
    close(tn(_t(x)).detach(), jn.apply(var, x, EVAL)[0], ATOL)


def test_convnet_train_mode_and_running_statistics():
    from nf_tpu.nets.conditioners import ConvNet as JCN
    from nf_tpu_torch.nets.conditioners import ConvNet

    jn = JCN(2, 4, base_filters=8)
    var = jn.init(jax.random.PRNGKey(8))
    x = normal(8, (4, 6, 6, 2))
    tn = _load(ConvNet(2, 4, base_filters=8, device="cpu"), var).train()
    jy, st = jn.apply(var, x, TRAIN)
    close(tn(_t(x)).detach(), jy, ATOL)
    want = _load(ConvNet(2, 4, base_filters=8, device="cpu"),
                 {"params": var["params"], "state": st})
    for (name, got), (_, ref) in zip(tn.named_buffers(), want.named_buffers()):
        close(got, ref, 1e-6)


def test_conversion_refuses_mismatched_conv_shapes():
    from nf_tpu.nets.conditioners import ConvNet as JCN
    from nf_tpu_torch.convert import load_jax_variables
    from nf_tpu_torch.nets.conditioners import ConvNet
    from nf_tpu_torch.nets.layers import Conv2d

    var = to_numpy(JCN(2, 4, base_filters=8).init(jax.random.PRNGKey(0)))
    with pytest.raises(ValueError, match=r"\.v: shape"):
        load_jax_variables(ConvNet(2, 4, base_filters=16, device="cpu"), var)
    conv = {"params": var["params"][0], "state": {}}
    with pytest.raises(ValueError, match=r"\.g: shape"):
        load_jax_variables(Conv2d(2, 8, 1, device="cpu"), conv)


@pytest.mark.parametrize("odd", [False, True])
@pytest.mark.parametrize("masking,dims", [("checkerboard", (8, 8, 4)),
                                          ("channelwise", (8, 8, 4))])
def test_image_affine_coupling(masking, dims, odd):
    from nf_tpu.bijectors.coupling import AffineCoupling as JAC
    from nf_tpu_torch.bijectors.coupling import AffineCoupling

    jc = JAC(dims, masking=masking, odd=odd, base_filters=8)
    var = jc.init(jax.random.PRNGKey(5))
    x = normal(5, (6,) + dims)
    _, _, st = jc.forward(var, x * 1.5, TRAIN)
    var = {"params": {**var["params"], "s_log_scale": np.float32([0.7]),
                      "s_bias": np.float32([-0.1])}, "state": st}
    tc = _load(AffineCoupling(dims, masking=masking, odd=odd, base_filters=8,
                              device="cpu"), var)
    assert tc.half_dims() == jc.half_dims()
    with torch.no_grad():
        y, ld = tc(_t(x))
        jy, jld, _ = jc.forward(var, x, EVAL)
        close(y, jy, ATOL)
        close(ld, jld, ATOL)
        xr, ldi = tc.inverse(_t(jy))
        jx, jldi, _ = jc.inverse(var, jy, EVAL)
        close(xr, jx, ATOL)
        close(ldi, jldi, ATOL)
        close(xr, x, 1e-5)


@pytest.mark.parametrize("affine", [False, True])
def test_flow_batchnorm_train_mode(affine):
    """Batch statistics with eps in varb, the running and cached batch
    statistics, and the training-mode inverse on the cached ones."""
    from nf_tpu.bijectors.norm import BatchNorm as JBN
    from nf_tpu_torch.bijectors.norm import BatchNorm

    jb = JBN(3, affine=affine)
    var = jb.init(jax.random.PRNGKey(4))
    _, _, st = jb.forward(var, normal(3, (16, 4, 4, 3)), TRAIN)
    params = var["params"]
    if affine:
        params = {"log_gamma": params["log_gamma"] + 0.3, "beta": params["beta"] - 0.2}
    var = {"params": params, "state": st}
    tb = _load(BatchNorm(3, affine=affine, device="cpu"), var).train()
    x = normal(4, (8, 4, 4, 3), 1.7) + 0.4
    y, ld = tb(_t(x))
    jy, jld, jst = jb.forward(var, x, TRAIN)
    close(y.detach(), jy, ATOL)
    close(ld.detach(), jld, ATOL)
    for k in ("running_mean", "running_var", "batch_mean", "batch_var"):
        close(getattr(tb, k), jst[k], 1e-6)
    var = {"params": params, "state": jst}
    xr, ldi = tb.inverse(y.detach())
    jx, jldi, _ = jb.inverse(var, jy, TRAIN)
    close(xr, jx, ATOL)
    close(ldi, jldi, ATOL)
    close(xr, x, 1e-5)


def test_batchnorm_net_train_mode():
    from nf_tpu.nets.layers import BatchNormNet as JBN
    from nf_tpu_torch.nets.layers import BatchNormNet

    jb = JBN(4)
    var = jb.init(jax.random.PRNGKey(2))
    var = {"params": {"gamma": var["params"]["gamma"] * 1.5,
                      "beta": var["params"]["beta"] + 0.25}, "state": var["state"]}
    tb = _load(BatchNormNet(4, device="cpu"), var).train()
    x = normal(2, (5, 3, 3, 4), 2.0) + 0.5
    jy, st = jb.apply(var, x, TRAIN)
    close(tb(_t(x)).detach(), jy, ATOL)
    close(tb.running_mean, st["running_mean"], 1e-6)
    # the BIASED batch variance moves running_var, as in nf_tpu
    close(tb.running_var, st["running_var"], 1e-6)
    biased = x.reshape(-1, 4).var(axis=0)
    close(tb.running_var, 0.9 + 0.1 * biased, 1e-5)


def test_actnorm_dd_init():
    from nf_tpu.bijectors.norm import ActNorm as JAN
    from nf_tpu_torch.bijectors.norm import ActNorm

    ja = JAN(3)
    x = normal(9, (6, 4, 4, 3), 2.0) - 0.7
    jvar, jy = ja.dd_init(ja.init(jax.random.PRNGKey(0)), x, TRAIN)
    ta = ActNorm(3, device="cpu")
    y = ta.dd_init(_t(x))
    close(y, jy, ATOL)
    close(ta.log_scale.detach(), jvar["params"]["log_scale"], 1e-6)
    close(ta.bias.detach(), jvar["params"]["bias"], 1e-6)
    assert bool(ta.initialized)


@pytest.fixture(scope="module")
def small_image():
    jm, var = jax_image_model((16, 16, 1), layers=1, filters=8, seed=0, batch=16)
    return jm, var, torch_image_model((16, 16, 1), 1, 8, var)


def _close_ld(a, b):
    close(a, b, 3e-4)


def _half_width(c):
    """Width of a coupling's flattened transformed half."""
    h, w, _ = c.dims
    return c.out_chs * h * w // (4 if c.masking == "checkerboard" else 1)


def test_image_realnvp_matches_nf_tpu(small_image):
    jm, var, tm = small_image
    from nf_tpu_torch.bijectors.coupling import AffineCoupling

    # four couplings, each half crossing the kernel's gate (128 wide)
    couplings = [m for m in tm.modules() if isinstance(m, AffineCoupling)]
    assert [_half_width(c) for c in couplings] == [128] * 4
    prog, jprog = tm.eval_program(), jm.eval_program(var)
    assert prog.stack is None             # the eager chain
    x = uniform(11, (24, 16, 16, 1))
    z, ld = prog.forward(_t(x))
    jz, jld = jprog.forward(x)
    close(z, jz, 1e-4)
    _close_ld(ld, jld)
    _close_ld(prog.log_prob(_t(x)), jprog.log_prob(x))
    zin = normal(12, (24, 16, 16, 1))
    y, ldi = prog.inverse(_t(zin))
    jy, jldi = jprog.inverse(zin)
    close(y, jy, 1e-4)
    _close_ld(ldi, jldi)


def test_image_realnvp_sample_given_z(small_image):
    jm, var, tm = small_image
    from nf_tpu.ops.math import standard_normal_logprob as jlogp

    zin = normal(13, (10, 16, 16, 1))
    jy, jldi, _ = jm.inverse(var, zin, EVAL)
    tm.eval()
    y, log_py = tm.sample(10, torch.Generator().manual_seed(3))
    z = torch.randn((10, 16, 16, 1), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        y2, _ = tm.inverse(z)
        yj, ldij = tm.inverse(_t(zin))
    close(y, y2, 0.0)
    close(yj, jy, 1e-4)
    from nf_tpu_torch.ops.math import standard_normal_logprob
    _close_ld(standard_normal_logprob(_t(zin)) - ldij, jlogp(zin) - jldi)
    # Logit(0.01, compress=True) maps R onto (-0.01/0.98, 1 + 0.01/0.98)
    assert torch.isfinite(log_py).all() and y.abs().max() < 1.0103


def test_headline_image_model_structure():
    """realnvp-img32x1 (bench.py's image zoo): 161 couplings, every half 512
    wide, 6,818,978 parameters."""
    from nf_tpu_torch.bijectors.coupling import AffineCoupling
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.models import build_model

    model = build_model("realnvp", (32, 32, 1), "image", NetworkConfig(), device="cpu")
    couplings = [m for m in model.modules() if isinstance(m, AffineCoupling)]
    assert len(couplings) == 161
    assert {_half_width(c) for c in couplings} == {512}
    assert sum(p.numel() for p in model.parameters()) == 6_818_978
