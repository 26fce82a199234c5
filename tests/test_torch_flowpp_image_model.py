"""The port's image Flow++ model against nf_tpu's, on the CPU.

flow++ image at 16x16x1, layers = 1, base_filters = 8, mixtures = 2 (the
shape of tests/test_zoo_image.py), and at 8x8x3, after nf_tpu's
data-dependent init (ActNorm) with every parameter moved off its init:
``log_prob`` and the EvalProgram's forward against nf_tpu's, log p and the
log-dets atol 3e-4 (sums of 256 or 192 terms), z atol 1e-4; the inverse of
the forward's latent, x atol 1e-3 (nf_tpu's own image round trip for
Flow++) and its log-det 5e-3 (the Newton solves).

flowpp-img32x1 itself (nf_tpu's defaults at 32x32x1): 488 layers, 161
couplings, 20,461,106 parameters, attention over 256, 64 and 16 tokens
64, 64 and 33 times a pass, and nf_tpu's variables for it load.
"""
import jax
import numpy as np
import pytest
import torch
from _torch_parity import close, normal, to_numpy, uniform


def _t(a):
    return torch.from_numpy(np.array(a))


def _moved(var, seed, scale):
    """Every parameter moved off its init by seeded noise."""
    leaves, tree = jax.tree.flatten(to_numpy(var)["params"])
    leaves = [np.asarray(l) + normal(seed + i, np.shape(l), scale)
              for i, l in enumerate(leaves)]
    return {"params": jax.tree.unflatten(tree, leaves), "state": to_numpy(var)["state"]}


def _jax_flowpp_image(dims, seed):
    from nf_tpu.config import NetworkConfig
    from nf_tpu.models import build_model

    cfg = NetworkConfig(name="flow++", layers=1, base_filters=8, mixtures=2)
    model = build_model("flow++", dims, datatype="image", cfg=cfg)
    var = model.init(jax.random.PRNGKey(seed))
    var = model.data_dependent_init(var, uniform(seed + 100, (16,) + dims))
    return model, _moved(var, seed + 200, 0.05)


def _torch_flowpp_image(dims, var=None, **kw):
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.convert import load_jax_variables
    from nf_tpu_torch.models import build_model

    cfg = NetworkConfig(name="flow++", layers=1, base_filters=8, mixtures=2, **kw)
    model = build_model("flow++", dims, "image", cfg, device="cpu")
    if var is not None:
        load_jax_variables(model, var)
    return model


@pytest.mark.parametrize("dims", [(16, 16, 1), (8, 8, 3)])
def test_image_flowpp_matches_nf_tpu(dims):
    from nf_tpu_torch.ops.cuda import attention as cattn

    jm, var = _jax_flowpp_image(dims, 0)
    tm = _torch_flowpp_image(dims, var)
    prog, jprog = tm.eval_program(), jm.eval_program(var)
    assert prog.stack is None             # the eager chain, as nf_tpu's jitted chain
    x = uniform(11, (8,) + dims)
    before = dict(cattn.LAUNCHES)
    z, ld = prog.forward(_t(x))
    jz, jld = jprog.forward(x)
    close(z, jz, 1e-4)
    close(ld, jld, 3e-4)
    close(prog.log_prob(_t(x)), jprog.log_prob(x), 3e-4)
    with torch.no_grad():
        close(tm.log_prob(_t(x)), jprog.log_prob(x), 3e-4)
    xr, ldi = prog.inverse(z)
    jx, jldi = jprog.inverse(jz)
    close(xr, jx, 1e-3)
    close(xr, x, 1e-3)
    close(ldi, jldi, 5e-3)
    assert cattn.LAUNCHES == before       # a CPU tensor launches nothing


def test_unported_options_raise():
    """scan and remat, refused before the port had them, build nf_tpu's
    structure (two 6-layer blocks and a tail) and serve its log p within
    3e-4 (var_dequant: tests/test_torch_vardequant.py)."""
    from _torch_parity import flag_parity

    for kw in (dict(scan=True), dict(remat=True)):
        flag_parity("flow++", (8, 8, 1), "image", 3e-4, layers=4, base_filters=8, mixtures=2,
                    **kw)


def test_flowpp_img32x1_structure_and_conversion():
    """nf_tpu's image Flow++ at its defaults: 488 layers (Logit, 161 x
    [ActNorm, InvertibleConv1x1, MixLogAttnCoupling], two squeezes and two
    unsqueezes), 20,461,106 parameters; its variables load into the port."""
    from nf_tpu.config import NetworkConfig as JNC
    from nf_tpu.models import build_model as jbuild
    from nf_tpu_torch.bijectors.flowpp_coupling import MixLogAttnCoupling
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.convert import load_jax_variables
    from nf_tpu_torch.models import build_model
    from nf_tpu_torch.nets.gated import GatedAttn

    model = build_model("flow++", (32, 32, 1), "image", NetworkConfig(name="flow++"),
                        device="cpu")
    assert len(model.bijector.layers) == 488
    assert sum(isinstance(m, MixLogAttnCoupling) for m in model.modules()) == 161
    assert sum(p.numel() for p in model.parameters()) == 20_461_106
    lengths = [m.in_shape[0] * m.in_shape[1] for m in model.modules()
               if isinstance(m, GatedAttn)]
    assert {L: lengths.count(L) for L in set(lengths)} == {256: 64, 64: 64, 16: 33}
    jm = jbuild("flow++", (32, 32, 1), datatype="image", cfg=JNC(name="flow++"))
    var = to_numpy(jm.init(jax.random.PRNGKey(0)))
    state = load_jax_variables(model, var)
    conv = model.bijector.layers[2]
    close(conv.log_s.detach(), var["params"][2]["log_s"], 0.0)
    assert len(state) == len(model.state_dict())
