"""Per-module parity of the PyTorch port against nf_tpu on the CPU: the same
numpy inputs and the same variables through both, atol 2e-5 (f32 sums
taken in another order)."""
import jax
import numpy as np
import pytest
import torch
from _torch_parity import close, normal, to_numpy

from nf_tpu.core import Ctx

ATOL = 2e-5
EVAL = Ctx(rng=None, train=False)
TRAIN = Ctx(rng=None, train=True)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _load(module, var):
    from nf_tpu_torch.convert import load_jax_variables
    load_jax_variables(module, to_numpy(var))
    return module.eval()


def test_math_helpers():
    from nf_tpu.ops import math as jm
    from nf_tpu_torch.ops import math as tm

    z = normal(0, (7, 3, 2))
    close(tm.sum_except_batch(_t(z)), jm.sum_except_batch(z), ATOL)
    close(tm.standard_normal_logprob(_t(z)), jm.standard_normal_logprob(z), ATOL)


@pytest.mark.parametrize("weight_norm", [True, False])
def test_dense(weight_norm):
    from nf_tpu.nets.layers import Dense as JDense
    from nf_tpu_torch.nets.layers import Dense

    jd = JDense(3, 5, weight_norm=weight_norm)
    var = jd.init(jax.random.PRNGKey(1))
    x = normal(1, (9, 3))
    td = _load(Dense(3, 5, weight_norm=weight_norm, device="cpu"), var)
    close(td(_t(x)).detach(), jd.apply(var, x, EVAL)[0], ATOL)


def test_dense_init_matches_weight_norm_convention():
    """The port's own init keeps the norm per input feature: g == ||v||
    over the out axis, and the effective weight has the drawn norms."""
    from nf_tpu_torch.nets.layers import Dense

    d = Dense(4, 6, device="cpu")
    d.init(torch.Generator().manual_seed(0))
    vn = torch.linalg.vector_norm(d.v, dim=0)
    close(vn.detach(), np.ones(4), 1e-4)
    close(torch.linalg.vector_norm(d.weight(), dim=0).detach(), d.g.detach(), 1e-5)


def test_batchnorm_net_eval():
    from nf_tpu.nets.layers import BatchNormNet as JBN
    from nf_tpu_torch.nets.layers import BatchNormNet

    jb = JBN(4)
    var = jb.init(jax.random.PRNGKey(2))
    x = normal(2, (16, 4), 2.0)
    # one train-mode pass moves the running statistics off init
    _, st = jb.apply(var, x + 0.5, TRAIN)
    var = {"params": {"gamma": var["params"]["gamma"] * 1.5,
                      "beta": var["params"]["beta"] + 0.25}, "state": st}
    tb = _load(BatchNormNet(4, device="cpu"), var)
    close(tb(_t(x)).detach(), jb.apply(var, x, EVAL)[0], ATOL)


def test_batchnorm_net_training_raises():
    """Train mode is ported: batch statistics, and the running statistics
    moved toward the biased batch variance, as nf_tpu."""
    from nf_tpu.nets.layers import BatchNormNet as JBN
    from nf_tpu_torch.nets.layers import BatchNormNet

    jb = JBN(3)
    var = jb.init(jax.random.PRNGKey(3))
    x = normal(3, (10, 3), 1.5) - 0.2
    tb = _load(BatchNormNet(3, device="cpu"), var).train()
    jy, st = jb.apply(var, x, TRAIN)
    close(tb(_t(x)).detach(), jy, ATOL)
    close(tb.running_mean, st["running_mean"], 1e-6)
    close(tb.running_var, st["running_var"], 1e-6)


@pytest.mark.parametrize("in_f,out_f", [(1, 2), (2, 4)])
def test_mlp(in_f, out_f):
    from nf_tpu.nets.conditioners import MLP as JMLP
    from nf_tpu_torch.nets.conditioners import MLP

    jm = JMLP(in_f, out_f, base_filters=8)
    var = jm.init(jax.random.PRNGKey(3))
    x = normal(3, (32, in_f))
    _, st = jm.apply(var, x * 2.0 + 1.0, TRAIN)
    var = {"params": var["params"], "state": st}
    tm = _load(MLP(in_f, out_f, base_filters=8, device="cpu"), var)
    close(tm(_t(x)).detach(), jm.apply(var, x, EVAL)[0], ATOL)


@pytest.mark.parametrize("in_f,out_f", [(4, 4), (3, 5)])
def test_resblock_linear(in_f, out_f):
    """Equal widths add the input back; unequal widths go through the
    bridge projection."""
    from nf_tpu.nets.conditioners import ResBlockLinear as JRB
    from nf_tpu_torch.nets.conditioners import ResBlockLinear

    jr = JRB(in_f, out_f)
    var = jr.init(jax.random.PRNGKey(6))
    x = normal(6, (24, in_f))
    _, st = jr.apply(var, x - 0.3, TRAIN)
    var = {"params": var["params"], "state": st}
    tr = _load(ResBlockLinear(in_f, out_f, device="cpu"), var)
    assert (tr.bridge is None) == (in_f == out_f)
    close(tr(_t(x)).detach(), jr.apply(var, x, EVAL)[0], ATOL)


@pytest.mark.parametrize("affine", [False, True])
def test_flow_batchnorm(affine):
    from nf_tpu.bijectors.norm import BatchNorm as JBN
    from nf_tpu_torch.bijectors.norm import BatchNorm

    jb = JBN(3, affine=affine)
    var = jb.init(jax.random.PRNGKey(4))
    x = normal(4, (16, 3), 1.7)
    _, _, st = jb.forward(var, x - 0.4, TRAIN)
    params = var["params"]
    if affine:
        params = {"log_gamma": params["log_gamma"] + 0.3,
                  "beta": params["beta"] - 0.2}
    var = {"params": params, "state": st}
    tb = _load(BatchNorm(3, affine=affine, device="cpu"), var)

    y, ld = tb(_t(x))
    jy, jld, _ = jb.forward(var, x, EVAL)
    close(y, jy, ATOL)
    close(ld, jld, ATOL)
    xr, ldi = tb.inverse(y)
    jx, jldi, _ = jb.inverse(var, jy, EVAL)
    close(xr, jx, ATOL)
    close(ldi, jldi, ATOL)


@pytest.mark.parametrize("D", [2, 3])
@pytest.mark.parametrize("odd", [False, True])
def test_affine_coupling(D, odd):
    from nf_tpu.bijectors.coupling import AffineCoupling as JAC
    from nf_tpu_torch.bijectors.coupling import AffineCoupling

    jc = JAC((D,), odd=odd, base_filters=8)
    var = jc.init(jax.random.PRNGKey(5))
    x = normal(5 + D, (32, D))
    _, _, st = jc.forward(var, x * 1.5, TRAIN)
    var = {"params": {**var["params"], "s_log_scale": np.float32([0.7]),
                      "s_bias": np.float32([-0.1])}, "state": st}
    tc = _load(AffineCoupling((D,), odd=odd, base_filters=8, device="cpu"), var)

    with torch.no_grad():
        y, ld = tc(_t(x))
        jy, jld, _ = jc.forward(var, x, EVAL)
        close(y, jy, ATOL)
        close(ld, jld, ATOL)
        xr, ldi = tc.inverse(y)
        jx, jldi, _ = jc.inverse(var, jy, EVAL)
        close(xr, jx, ATOL)
        close(ldi, jldi, ATOL)


def test_image_coupling_not_in_this_slice():
    """Image couplings are ported: a ConvNet conditioner over NHWC halves,
    with nf_tpu's half sizes (tests/test_torch_image.py holds them to
    nf_tpu)."""
    from nf_tpu_torch.bijectors.coupling import AffineCoupling
    from nf_tpu_torch.nets.layers import Conv2d

    for masking, halves in (("checkerboard", (4, 4)), ("channelwise", (1, 1))):
        c = AffineCoupling((4, 4, 2), masking=masking, base_filters=8, device="cpu")
        c.init(torch.Generator().manual_seed(0))
        assert c.half_dims() == halves and isinstance(c.net.layers[0], Conv2d)
        x = torch.from_numpy(normal(1, (3, 4, 4, 2)))
        with torch.no_grad():
            y, ld = c.eval()(x)
            xr, ldi = c.inverse(y)
        close(xr, x, 1e-5)
        close(ldi, -ld, 1e-5)


@pytest.mark.parametrize("name,dims,datatype,kw", [
    ("ffjord", (2,), "2d", {}),
    ("flow++", (8, 8, 1), "image", dict(layers=1, base_filters=8, mixtures=2,
                                        var_dequant=True))], ids=["ffjord", "flowpp-var_dequant"])
def test_new_families_build(name, dims, datatype, kw):
    """FFJORD at NETWORK_DEFAULTS (3 x [ActNorm -> CNF], dopri5, adjoint,
    Hutchinson, rtol / atol 1e-4, the grid of stepsize 0.1) and Flow++
    with variational dequantization build; with scan they build nf_tpu's
    structure (FFJORD 2-D as a ScannedChain) and its variables."""
    from _torch_parity import flag_parity
    from nf_tpu.config import NETWORK_DEFAULTS as JDEFAULTS
    from nf_tpu_torch.bijectors import CNF, VariationalDequant
    from nf_tpu_torch.config import NETWORK_DEFAULTS, NetworkConfig
    from nf_tpu_torch.models import available_models, build_model

    assert name in available_models()
    cfg = NetworkConfig(name=name, **{**NETWORK_DEFAULTS[name], **kw})
    model = build_model(name, dims, datatype, cfg, device="cpu")
    layers = list(model.bijector.layers)
    if name == "ffjord":
        assert NETWORK_DEFAULTS["ffjord"] == JDEFAULTS["ffjord"]
        cnfs = layers[1::2]
        assert len(layers) == 6 and all(isinstance(c, CNF) for c in cnfs)
        c = cnfs[0]
        assert (c.solver, c.backprop, c.trace_estimator, c.rtol, c.atol) == (
            "dopri5", "adjoint", "hutchinson", 1e-4, 1e-4)
        close(c.times, np.linspace(0.0, 1.0, 11, dtype=np.float32), 0.0)
    else:
        assert isinstance(layers[0], VariationalDequant)
    kw = {k: v for k, v in cfg.__dict__.items() if k != "name"}
    flag_parity(name, dims, datatype, logp=False, **{**kw, "scan": True})


@pytest.mark.parametrize("name", ["Identity", "Sigmoid", "Tanh", "Arctanh"])
def test_elementwise_bijectors(name):
    """The parameter-free bijectors no model uses: forward and inverse
    against nf_tpu's, within ATOL (log-dets rtol 1e-6), including inputs
    at and past the clamps."""
    from nf_tpu.bijectors import elementwise as je
    from nf_tpu_torch.bijectors import elementwise as te

    jb, tb = getattr(je, name)(), getattr(te, name)()
    var = jb.init(jax.random.PRNGKey(0))
    x = normal(40, (16, 6), 2.0)
    inside = np.tanh(x) if name in ("Tanh", "Arctanh") else 1.0 / (1.0 + np.exp(-x))
    inside[0, :3] = (1.0, -1.0, 0.0) if name != "Sigmoid" else (1.0, 0.0, 1e-9)
    for direction, inp in (("forward", x), ("inverse", inside)):
        if name == "Arctanh":                    # its forward takes (-1, 1)
            inp = inside if direction == "forward" else x
        y, ld = getattr(tb, direction)(_t(inp))
        jy, jld, _ = getattr(jb, direction)(var, inp, EVAL)
        close(y, jy, ATOL, 1e-6)
        close(ld, jld, ATOL, 1e-6)
    assert tb.init(torch.Generator()) is None and not list(tb.parameters())


@pytest.mark.parametrize("dims,masking", [((3,), "checkerboard"), ((4, 4, 2), "checkerboard"),
                                          ((4, 4, 2), "channelwise")])
def test_additive_coupling(dims, masking):
    """NICE's coupling against nf_tpu's, in train and eval mode, its
    variables carried across and exported back; log-det 0."""
    from nf_tpu.bijectors.coupling import AdditiveCoupling as JAdd
    from nf_tpu_torch.bijectors.coupling import AdditiveCoupling
    from nf_tpu_torch.convert import export_jax_variables

    from _torch_parity import assert_trees_equal

    jc = JAdd(dims, masking=masking, odd=True, base_filters=8)
    var = jc.init(jax.random.PRNGKey(6))
    x = normal(41, (8,) + dims)
    _, _, st = jc.forward(var, x * 1.5, TRAIN)       # running statistics off init
    var = to_numpy({"params": var["params"], "state": st})
    tc = _load(AdditiveCoupling(dims, masking=masking, odd=True, base_filters=8,
                                device="cpu"), var)
    assert_trees_equal(export_jax_variables(tc), var)
    with torch.no_grad():
        y, ld = tc(_t(x))
        jy, jld, _ = jc.forward(var, x, EVAL)
        close(y, jy, ATOL)
        assert not ld.any() and not np.asarray(jld).any()
        xr, _ = tc.inverse(y)
        close(xr, x, ATOL)
        tc.train()
        y, _ = tc(_t(x))
        jy, _, jst = jc.forward(var, x, TRAIN)
        close(y, jy, ATOL)
    moved = export_jax_variables(tc)["state"]
    jax.tree.map(lambda a, b: close(a, b, ATOL), moved, to_numpy(jst))
