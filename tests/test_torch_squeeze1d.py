"""The port's 1-D squeeze and ``models.register`` against nf_tpu's, on the
CPU.

``squeeze1d`` / ``unsqueeze1d`` and the ``Squeeze1d`` / ``Unsqueeze1d``
bijectors move entries and nothing else, so they are held bit for bit,
with a zero log-det of shape (B,) in f32.  A chain
``Squeeze1d -> 4 x [BatchNorm -> AffineCoupling] -> Unsqueeze1d`` at
D = 4, registered under one name in both packages and built through
``build_model``, matches no fused pattern in either and serves its eager
chain; log p agrees to 1e-4.
"""
import jax
import numpy as np
import pytest
import torch
from _torch_parity import close, normal, to_numpy

NAME = "squeeze1d-realnvp"
D, LAYERS, FILTERS = 4, 4, 8


@pytest.mark.parametrize("odd", (False, True))
@pytest.mark.parametrize("dim", (2, 6, 64))
def test_squeeze1d_ops_match_nf_tpu(dim, odd):
    from nf_tpu.ops import squeeze as nf_sq

    from nf_tpu_torch.ops import squeeze as sq

    z = normal(dim, (5, dim))
    halves = sq.squeeze1d(torch.from_numpy(z), odd)
    for got, want in zip(halves, nf_sq.squeeze1d(z, odd)):
        assert got.shape == (5, dim // 2)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(sq.unsqueeze1d(*halves, odd).numpy(), z)
    a, b = normal(dim + 1, (5, dim // 2)), normal(dim + 2, (5, dim // 2))
    np.testing.assert_array_equal(
        sq.unsqueeze1d(torch.from_numpy(a), torch.from_numpy(b), odd).numpy(),
        np.asarray(nf_sq.unsqueeze1d(a, b, odd)))


@pytest.mark.parametrize("odd", (False, True))
@pytest.mark.parametrize("dim", (2, 6, 64))
@pytest.mark.parametrize("cls", ("Squeeze1d", "Unsqueeze1d"))
def test_squeeze1d_bijectors_match_nf_tpu(cls, dim, odd):
    import nf_tpu.bijectors as nf_bij
    from nf_tpu.core import Ctx

    import nf_tpu_torch.bijectors as bij

    jb, tb = getattr(nf_bij, cls)(odd), getattr(bij, cls)(odd)
    assert not list(tb.parameters()) and not list(tb.buffers())
    var, ctx = {"params": {}, "state": {}}, Ctx()
    z = normal(dim + 3, (7, dim))
    y, ld = tb(torch.from_numpy(z))
    jy, jld, _ = jb.forward(var, z, ctx)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    xr, ldi = tb.inverse(y)
    jx, _, _ = jb.inverse(var, np.asarray(jy), ctx)
    np.testing.assert_array_equal(xr.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(xr.numpy(), z)
    for t in (ld, ldi):
        assert t.shape == (7,) and t.dtype == torch.float32 and t.device == y.device
        assert not t.any()
    np.testing.assert_array_equal(np.asarray(jld), 0.0)


def _nf_builder(dims, datatype=None, cfg=None):
    from nf_tpu.bijectors import AffineCoupling, BatchNorm, Squeeze1d, Unsqueeze1d
    from nf_tpu.core import Chain
    from nf_tpu.models import FlowModel

    layers = [l for i in range(LAYERS) for l in (
        BatchNorm(dims[-1], affine=False),
        AffineCoupling(dims, odd=i % 2 != 0, base_filters=FILTERS))]
    return FlowModel(NAME, Chain([Squeeze1d()] + layers + [Unsqueeze1d()]), dims)


def _port_builder(dims, datatype=None, cfg=None, device=None):
    from nf_tpu_torch.bijectors import AffineCoupling, BatchNorm, Squeeze1d, Unsqueeze1d
    from nf_tpu_torch.core import Chain
    from nf_tpu_torch.models import FlowModel

    layers = [l for i in range(LAYERS) for l in (
        BatchNorm(dims[-1], affine=False, device=device),
        AffineCoupling(dims, odd=i % 2 != 0, base_filters=FILTERS, device=device))]
    return FlowModel(NAME, Chain([Squeeze1d()] + layers + [Unsqueeze1d()]), dims, device)


@pytest.fixture
def registered(monkeypatch):
    """The builders registered in both packages, for this test only."""
    import nf_tpu.models as nf_models

    import nf_tpu_torch.models as models

    monkeypatch.setattr(nf_models, "_REGISTRY", dict(nf_models._REGISTRY))
    monkeypatch.setattr(models, "_REGISTRY", dict(models._REGISTRY))
    nf_models.register(NAME, _nf_builder)
    models.register(NAME, _port_builder)
    return nf_models, models


def test_registered_squeeze1d_chain_matches_nf_tpu(registered):
    from nf_tpu.core import Ctx

    from nf_tpu_torch.convert import load_jax_variables

    nf_models, models = registered
    assert NAME in nf_models.available_models() and NAME in models.available_models()
    jmodel = nf_models.build_model(NAME, (D,), "2d")
    tmodel = models.build_model(NAME, (D,), "2d", device="cpu")
    key = jax.random.PRNGKey(6)
    var = jmodel.init(key)
    x = normal(106, (64, D))
    var = jmodel.data_dependent_init(var, x * 1.5 + 0.3)
    # move the batch norms' running statistics and the couplings' scales
    # off their init values
    ctx_t = Ctx(rng=jax.random.fold_in(key, 2), train=True)
    fwd = jax.jit(lambda v, y: jmodel.bijector.forward(v, y, ctx_t)[2])
    for _ in range(3):
        var = {"params": var["params"], "state": fwd(var, x * 1.3)}
    rng = np.random.default_rng(6)
    var = to_numpy(var)
    var["params"] = jax.tree.map(
        lambda a: (a + 0.2 * rng.standard_normal(a.shape)).astype(np.float32), var["params"])
    load_jax_variables(tmodel, var)

    assert jmodel._fused_spec is None
    prog = tmodel.eval_program()
    assert prog.stack is None
    xs = normal(107, (64, D))
    jprog = jmodel.eval_program(var)
    close(prog.log_prob(torch.from_numpy(xs)), jprog.log_prob(xs), 1e-4)
    z, _ = prog.forward(torch.from_numpy(xs))
    y, _ = prog.inverse(z)
    close(y, xs, 1e-4)


def test_build_model_hands_a_registered_builder_its_cfg(registered):
    _, models = registered
    seen = []

    def builder(dims, datatype=None, cfg=None, device=None):
        seen.append(cfg)
        return _port_builder(dims, datatype, cfg, device)

    models.register("probe", builder)
    models.build_model("probe", (D,), "2d", device="cpu")
    cfg = object()
    models.build_model("probe", (D,), "2d", cfg=cfg, device="cpu")
    assert seen == [None, cfg]
