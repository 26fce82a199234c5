"""The port's image Glow model against nf_tpu's, on the CPU.

glow image at 16x16x3, layers = 1, base_filters = 8: Logit, then
[ActNorm, InvertibleConv1x1, checkerboard AffineCoupling], Squeeze2d, the
same channelwise, a final checkerboard block of two and Unsqueeze2d; four
couplings, each flattened half 384 wide (the coupling kernel's gate is a
multiple of 128).  After nf_tpu's data-dependent init (ActNorm), train-mode
passes that move the conditioners' running statistics, and every parameter
moved off its init: the EvalProgram's forward and log p against nf_tpu's,
z atol 1e-4, the log-dets and log-densities atol 3e-4 + rtol 1e-6 (sums
of 768 terms that reach 1,200, where f32's spacing is 1.2e-4: the two
sums differ by a few of those); the inverse of a standard-normal latent,
x atol 1e-4 and its log-det the same; the round trip of the data, x atol
1e-4.  Train mode is held by tests/test_torch_train.py's three Adam
steps.

glow-img32x3 itself (bench.py's image zoo: 32x32x3, layers = 32,
base_filters = 32): 161 couplings, every half 1536 wide, and nf_tpu's
variables for it load, built without running it.
"""
import jax
import numpy as np
import pytest
import torch
from _torch_parity import close, normal, to_numpy, uniform

DIMS = (16, 16, 3)


def _t(a):
    return torch.from_numpy(np.array(a))


def _moved(var, seed, scale):
    """Every parameter moved off its init by seeded noise."""
    leaves, tree = jax.tree.flatten(to_numpy(var)["params"])
    leaves = [np.asarray(l) + normal(seed + i, np.shape(l), scale)
              for i, l in enumerate(leaves)]
    return {"params": jax.tree.unflatten(tree, leaves), "state": to_numpy(var)["state"]}


def _torch_glow_image(dims, var=None, **kw):
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.convert import load_jax_variables
    from nf_tpu_torch.models import build_model

    cfg = NetworkConfig(name="glow", **{"layers": 1, "base_filters": 8, **kw})
    model = build_model("glow", dims, "image", cfg, device="cpu")
    if var is not None:
        load_jax_variables(model, var)
    return model


@pytest.fixture(scope="module")
def small_glow():
    from nf_tpu.config import NetworkConfig
    from nf_tpu.core import Ctx
    from nf_tpu.models import build_model

    model = build_model("glow", DIMS, datatype="image",
                        cfg=NetworkConfig(name="glow", layers=1, base_filters=8))
    var = model.init(jax.random.PRNGKey(0))
    var = model.data_dependent_init(var, uniform(100, (16,) + DIMS))
    fwd = jax.jit(lambda v, y: model.bijector.forward(v, y, Ctx(rng=None, train=True))[2])
    for i in range(2):
        var = {"params": var["params"], "state": fwd(var, uniform(101 + i, (16,) + DIMS))}
    var = _moved(var, 200, 0.05)
    return model, var, _torch_glow_image(DIMS, var)


def _half_width(c):
    """Width of a coupling's flattened transformed half."""
    h, w, _ = c.dims
    return c.out_chs * h * w // (4 if c.masking == "checkerboard" else 1)


def test_image_glow_matches_nf_tpu(small_glow):
    from nf_tpu_torch.bijectors.coupling import AffineCoupling
    from nf_tpu_torch.ops.cuda import coupling as tc

    jm, var, tm = small_glow
    couplings = [m for m in tm.modules() if isinstance(m, AffineCoupling)]
    assert [(c.masking, _half_width(c)) for c in couplings] == [
        ("checkerboard", 384), ("channelwise", 384), ("checkerboard", 384),
        ("checkerboard", 384)]
    assert [c.odd for c in couplings] == [False, False, False, True]
    prog, jprog = tm.eval_program(), jm.eval_program(var)
    assert prog.stack is None             # the eager chain, as nf_tpu's jitted chain
    x = uniform(11, (12,) + DIMS)
    before = dict(tc.LAUNCHES)
    z, ld = prog.forward(_t(x))
    jz, jld = jprog.forward(x)
    close(z, jz, 1e-4)
    close(ld, jld, 3e-4, 1e-6)
    close(prog.log_prob(_t(x)), jprog.log_prob(x), 3e-4, 1e-6)
    with torch.no_grad():
        close(tm.log_prob(_t(x)), jprog.log_prob(x), 3e-4, 1e-6)
    zin = normal(12, (12,) + DIMS)
    y, ldi = prog.inverse(_t(zin))
    jy, jldi = jprog.inverse(zin)
    close(y, jy, 1e-4)
    close(ldi, jldi, 3e-4, 1e-6)
    xr, _ = prog.inverse(z)
    close(xr, x, 1e-4)
    assert tc.LAUNCHES == before          # a CPU tensor launches nothing


def test_unported_options_raise():
    """scan and remat, refused before the port had them, build nf_tpu's
    structure and serve its log p (3e-4 image, 1e-4 2-D)."""
    from _torch_parity import flag_parity

    for datatype, dims, atol in (("image", (8, 8, 3), 3e-4), ("2d", (2,), 1e-4)):
        for kw in (dict(scan=True), dict(remat=True)):
            flag_parity("glow", dims, datatype, atol, layers=4, base_filters=8, **kw)


def test_glow_img32x3_structure_and_conversion():
    """glow-img32x3: 484 layers (Logit, 161 x [ActNorm, InvertibleConv1x1,
    AffineCoupling], two squeezes and unsqueezes), every half 1536 wide;
    nf_tpu's variables for it load."""
    from nf_tpu.config import NetworkConfig as JNC
    from nf_tpu.models import build_model as jbuild
    from nf_tpu_torch.bijectors.conv1x1 import InvertibleConv1x1
    from nf_tpu_torch.bijectors.coupling import AffineCoupling
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.convert import load_jax_variables
    from nf_tpu_torch.models import build_model

    model = build_model("glow", (32, 32, 3), "image", NetworkConfig(name="glow"), device="cpu")
    assert len(model.bijector.layers) == 1 + 3 * 161 + 4
    couplings = [m for m in model.modules() if isinstance(m, AffineCoupling)]
    assert len(couplings) == 161
    assert {_half_width(c) for c in couplings} == {1536}
    convs = [m for m in model.modules() if isinstance(m, InvertibleConv1x1)]
    assert sorted({c.num_channels for c in convs}) == [3, 12, 48]
    jm = jbuild("glow", (32, 32, 3), datatype="image", cfg=JNC(name="glow"))
    var = to_numpy(jm.init(jax.random.PRNGKey(0)))
    n_jax = sum(np.size(l) for l in jax.tree.leaves(var["params"]))
    assert sum(p.numel() for p in model.parameters()) == n_jax
    state = load_jax_variables(model, var)
    close(model.bijector.layers[2].log_s.detach(), var["params"][2]["log_s"], 0.0)
    assert len(state) == len(model.state_dict())
