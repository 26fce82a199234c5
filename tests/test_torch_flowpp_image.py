"""The port's image Flow++ modules against nf_tpu's, on the CPU.

Per module, atol 2e-5 (f32 sums in another order): ``GatedConv2d``,
``GatedAttn`` over an image's pixels (L > 1, the attention's plain
version), ``LayerNormNet`` over (h, w, f), ``ActNorm`` and
``InvertibleConv1x1`` on NHWC (forward and inverse), the logit-space
mixture transform at (B, H, W, C) with K last, and the image
``MixLogAttnCoupling`` (checkerboard and channelwise, odd and even): its
forward at 2e-5, its Newton inverse at 1e-4 on x and 1e-3 on the log-det
(two solves meet the root only within XTOL).  The whole model is in
tests/test_torch_flowpp_image_model.py.
"""
import jax
import numpy as np
import pytest
import torch
from _torch_parity import close, normal, to_numpy

from nf_tpu.core import Ctx

ATOL = 2e-5
INV_X_ATOL, INV_LD_ATOL = 1e-4, 1e-3
EVAL = Ctx(rng=None, train=False)


def _t(a):
    return torch.from_numpy(np.array(a))


def _load(module, var):
    from nf_tpu_torch.convert import load_jax_variables
    load_jax_variables(module, to_numpy(var))
    return module.eval()


def _moved(var, seed, scale=0.3):
    """Every parameter moved off its init by seeded noise."""
    leaves, tree = jax.tree.flatten(to_numpy(var)["params"])
    leaves = [np.asarray(l) + normal(seed + i, np.shape(l), scale)
              for i, l in enumerate(leaves)]
    return {"params": jax.tree.unflatten(tree, leaves), "state": to_numpy(var)["state"]}


# --------------------------------------------------------------- modules
def test_gated_conv2d():
    from nf_tpu.nets.gated import GatedConv2d as JGC
    from nf_tpu_torch.nets.gated import GatedConv2d

    jg = JGC(6)
    var = jg.init(jax.random.PRNGKey(1))
    x = normal(1, (3, 5, 4, 6), 1.5)
    tg = _load(GatedConv2d(6, device="cpu"), var)
    close(tg(_t(x)).detach(), jg.apply(var, x, EVAL)[0], ATOL)


@pytest.mark.parametrize("in_shape,filters", [((4, 4, 8), 8), ((8, 8, 16), 32), ((3, 5, 4), 4)])
def test_gated_attn_over_pixels(in_shape, filters):
    from nf_tpu.nets.gated import GatedAttn as JGA
    from nf_tpu_torch.nets.gated import GatedAttn

    ja = JGA(in_shape, filters)
    var = _moved(ja.init(jax.random.PRNGKey(2)), 3, 0.1)
    x = normal(2, (3,) + in_shape)
    ta = _load(GatedAttn(in_shape, filters, device="cpu"), var)
    close(ta(_t(x)).detach(), ja.apply(var, x, EVAL)[0], ATOL)


def test_layer_norm_net_over_an_image():
    from nf_tpu.nets.gated import LayerNormNet as JLN
    from nf_tpu_torch.nets.gated import LayerNormNet

    shape = (4, 4, 8)
    jl = JLN(shape)
    var = _moved(jl.init(jax.random.PRNGKey(3)), 4)
    x = normal(3, (5,) + shape, 2.0) + 0.7
    tl = _load(LayerNormNet(shape, device="cpu"), var)
    close(tl(_t(x)).detach(), jl.apply(var, x, EVAL)[0], ATOL)


@pytest.mark.parametrize("kind", ["actnorm", "conv1x1"])
def test_nhwc_bijectors(kind):
    from nf_tpu.bijectors.conv1x1 import InvertibleConv1x1 as JC
    from nf_tpu.bijectors.norm import ActNorm as JA
    from nf_tpu_torch.bijectors.conv1x1 import InvertibleConv1x1
    from nf_tpu_torch.bijectors.norm import ActNorm

    jb, tb = (JA(4), ActNorm(4, device="cpu")) if kind == "actnorm" else \
        (JC(4), InvertibleConv1x1(4, device="cpu"))
    var = jb.init(jax.random.PRNGKey(5))
    if kind == "actnorm":
        var = {"params": {"log_scale": normal(5, (4,), 0.3), "bias": normal(6, (4,), 0.3)},
               "state": var["state"]}
    tb = _load(tb, var)
    x = normal(7, (3, 6, 5, 4))
    with torch.no_grad():
        y, ld = tb(_t(x))
        jy, jld, _ = jb.forward(var, x, EVAL)
        close(y, jy, ATOL)
        close(ld, jld, ATOL)
        xr, ldi = tb.inverse(_t(jy))
        jx, jldi, _ = jb.inverse(var, jy, EVAL)
    close(xr, jx, ATOL)
    close(ldi, jldi, ATOL)
    close(xr, x, 1e-5)


def test_logit_mixture_at_an_image_shape():
    from nf_tpu.bijectors import mixlogcdf as jm
    from nf_tpu_torch.bijectors import mixlogcdf as tm

    shape, K = (3, 4, 4, 2), 5
    logpi = np.asarray(jax.nn.log_softmax(normal(8, shape + (K,), 1.5), axis=-1))
    mu, s = normal(9, shape + (K,), 2.0), normal(10, shape + (K,), 0.7)
    x = normal(11, shape, 3.0)
    y, ld = tm.mix_log_cdf_logit_forward(_t(x), _t(logpi), _t(mu), _t(s))
    jy, jld = jm.mix_log_cdf_logit_forward(x, logpi, mu, s)
    close(y, jy, ATOL, 1e-6)
    close(ld, jld, ATOL, 1e-6)
    xr, ldi = tm.mix_log_cdf_logit_inverse(_t(jy), _t(logpi), _t(mu), _t(s))
    jx, jldi = jm.mix_log_cdf_logit_inverse(np.asarray(jy), logpi, mu, s)
    close(xr, jx, INV_X_ATOL, 1e-6)
    close(ldi, jldi, INV_LD_ATOL)


@pytest.mark.parametrize("odd", [False, True])
@pytest.mark.parametrize("masking,dims", [("checkerboard", (8, 8, 2)),
                                          ("channelwise", (4, 4, 4))])
def test_image_mixlog_attn_coupling(masking, dims, odd):
    from nf_tpu.bijectors.flowpp_coupling import MixLogAttnCoupling as JC
    from nf_tpu_torch.bijectors.flowpp_coupling import MixLogAttnCoupling

    jc = JC(dims, masking=masking, odd=odd, base_filters=8, n_mixtures=3)
    var = to_numpy(jc.init(jax.random.PRNGKey(6)))
    var["params"]["a_log_scale"] = np.float32([0.6])
    var["params"]["a_bias"] = np.float32([-0.2])
    tc = _load(MixLogAttnCoupling(dims, masking=masking, odd=odd, base_filters=8,
                                  n_mixtures=3, device="cpu"), var)
    assert tc.half_dims() == jc.half_dims()
    assert tc.net.layers[3].in_shape == jc.net.layers[3].in_shape
    x = normal(12, (5,) + dims, 1.5)
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
