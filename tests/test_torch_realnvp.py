"""The port's RealNVP density serving path against nf_tpu's, on the CPU.

The whole slice at full depth (32 couplings, F = 32, D = 2): the port's
EvalProgram (its packed stack through the kernel's plain version) against
nf_tpu's ``eval_program`` (the jitted chain on the CPU).  atol 1e-4 on z
and the log-dets: f32 sums in another order, compounded through 32
``exp(s)`` factors.
"""
import pytest
import torch
from _torch_parity import close, jax_realnvp, normal, torch_realnvp

ATOL = 1e-4


@pytest.fixture(scope="module")
def full_depth():
    jmodel, var = jax_realnvp(2, 32, 32, seed=3, batch=256)
    return jmodel, var, torch_realnvp(2, 32, 32, var)


def test_eval_program_matches_nf_tpu_full_depth(full_depth):
    jmodel, var, tmodel = full_depth
    jprog = jmodel.eval_program(var)
    prog = tmodel.eval_program()
    assert prog.stack is not None          # the fused stack, not the chain
    x = normal(7, (256, 2))

    jz, jld = jprog.forward(x)
    z, ld = prog.forward(torch.from_numpy(x))
    close(z, jz, ATOL)
    close(ld, jld, ATOL)
    close(prog.log_prob(torch.from_numpy(x)), jprog.log_prob(x), ATOL)

    zin = normal(8, (256, 2))
    jy, jldi = jprog.inverse(zin)
    y, ldi = prog.inverse(torch.from_numpy(zin))
    close(y, jy, ATOL)
    close(ldi, jldi, ATOL)


def test_eval_program_sample_is_inverse_of_its_draw(full_depth):
    *_, tmodel = full_depth
    prog = tmodel.eval_program()
    y, log_py = prog.sample(64, torch.Generator().manual_seed(11))
    z = torch.randn(64, 2, generator=torch.Generator().manual_seed(11))
    y2, ldi = prog.inverse(z)
    close(y, y2, 0.0)
    from nf_tpu_torch.ops.math import standard_normal_logprob
    close(log_py, standard_normal_logprob(z) - ldi, 0.0)
    assert torch.isfinite(y).all() and torch.isfinite(log_py).all()


def test_eval_program_matches_eager_chain(full_depth):
    """The packed stack and the port's own eager chain agree."""
    *_, tmodel = full_depth
    prog = tmodel.eval_program()
    x = torch.from_numpy(normal(9, (128, 2)))
    with torch.no_grad():
        z, ld = tmodel(x)
        close(prog.forward(x)[0], z, ATOL)
        close(prog.forward(x)[1], ld, ATOL)
        close(tmodel.log_prob(x), prog.log_prob(x), ATOL)


def test_unfused_stack_runs_the_chain():
    """An odd number of couplings does not match the fused pattern; the
    EvalProgram then runs the eager chain, as nf_tpu runs its jitted chain."""
    jmodel, var = jax_realnvp(3, 3, 8, seed=4)
    tmodel = torch_realnvp(3, 3, 8, var)
    prog = tmodel.eval_program()
    assert prog.stack is None
    jprog = jmodel.eval_program(var)
    x = normal(12, (40, 3))
    jz, jld = jprog.forward(x)
    z, ld = prog.forward(torch.from_numpy(x))
    close(z, jz, 2e-5)
    close(ld, jld, 2e-5)
    y, ldi = prog.inverse(z)
    close(y, x, 1e-4)
    close(ldi, -ld, 1e-4)


def test_init_and_round_trip():
    model = torch_realnvp(2, 4, 8)
    params = model.init(torch.Generator().manual_seed(0))
    assert set(params) == set(model.state_dict())
    prog = model.eval_program(params)
    x = torch.from_numpy(normal(13, (50, 2)))
    z, ld = prog.forward(x)
    xr, ldi = prog.inverse(z)
    close(xr, x, 1e-5)
    close(ldi, -ld, 1e-5)
    y, log_py = model.sample(5, torch.Generator().manual_seed(1))
    assert y.shape == (5, 2) and log_py.shape == (5,)


def test_training_mode_raises():
    """Train mode is ported: a train-mode forward of the density model
    matches nf_tpu's (batch statistics) and moves the running statistics
    as nf_tpu's state update does."""
    import jax
    from nf_tpu.core import Ctx

    jmodel, var = jax_realnvp(2, 2, 8, seed=5)
    model = torch_realnvp(2, 2, 8, var).train()
    x = normal(14, (48, 2)) * 1.2 - 0.3
    jz, jld, jst = jmodel.forward(jax.tree.map(jax.numpy.asarray, var), x,
                                  Ctx(rng=None, train=True))
    z, ld = model(torch.from_numpy(x))
    close(z.detach(), jz, 2e-5)
    close(ld.detach(), jld, 2e-5)
    close(model.bijector.layers[0].running_mean, jst[0]["running_mean"], 1e-6)
    close(model.bijector.layers[0].batch_var, jst[0]["batch_var"], 1e-6)


def test_image_mode_not_in_this_slice():
    """The image tier is ported: at 8x8x1 the builder emits Logit, one
    final checkerboard block of layers + 1 couplings and no squeeze, and
    the model inverts itself (tests/test_torch_image.py holds the image
    model to nf_tpu)."""
    from nf_tpu_torch.bijectors.coupling import AffineCoupling
    from nf_tpu_torch.bijectors.elementwise import Logit
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.models import build_model

    model = build_model("realnvp", (8, 8, 1), "image", NetworkConfig(layers=2, base_filters=8),
                        device="cpu")
    layers = list(model.bijector.layers)
    assert isinstance(layers[0], Logit) and len(layers) == 1 + 2 * 3
    assert all(isinstance(c, AffineCoupling) and c.masking == "checkerboard"
               for c in layers[2::2])
    prog = model.eval_program(model.init(torch.Generator().manual_seed(0)))
    x = torch.rand(5, 8, 8, 1, generator=torch.Generator().manual_seed(1)) * 0.9 + 0.05
    z, ld = prog.forward(x)
    xr, ldi = prog.inverse(z)
    close(xr, x, 1e-5)
    close(ldi, -ld, 1e-3)
    with pytest.raises(ValueError, match="unknown network"):
        build_model("nice", (2,), "2d", device="cpu")


def test_default_config_is_the_headline_width():
    from nf_tpu_torch.config import NETWORK_DEFAULTS, NetworkConfig
    from nf_tpu_torch.models import build_model
    from nf_tpu_torch.ops.cuda.fused_stack import extract_stack_spec

    model = build_model("realnvp", (2,), "2d", device="cpu")
    spec = extract_stack_spec(model.bijector, model.dims)
    assert NETWORK_DEFAULTS["realnvp"]["layers"] == 32
    assert (spec.n_repeats, spec.dim, spec.filters) == (32, 2, NetworkConfig().base_filters)
