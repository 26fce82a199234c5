"""The port's bf16 options against nf_tpu's, on the CPU.

* ``compute_dtype="bfloat16"``: ``Dense`` and ``Conv2d`` against nf_tpu's
  bf16 layers on the same weights and inputs, within 2e-3 of the output's
  largest magnitude (JAX and torch agree on bf16 products to a bf16 ulp on
  a few elements; here exactly), bf16 out; a bf16 image RealNVP and Glow
  against nf_tpu's bf16 model run op by op (``jax.disable_jit``) within
  3e-4 of log p (the image bound): every bf16 rounding is then the same
  in both, and what is left is f32 noise.  Under jit XLA's CPU keeps bf16
  intermediates in f32 (nf_tpu's jitted program is up to 0.58 from its
  own op-by-op log p at |log p| = 252), so the jitted program is no
  reference for a bf16 model.  Master parameters stay f32, and the bf16
  model is measurably not the f32 one.
* Only RealNVP and Glow read ``compute_dtype``, as in nf_tpu: the other
  families build the same modules and give the same log p bit for bit.
* A bf16 RealNVP 2-D model keeps its fused spec (nf_tpu's
  ``extract_stack_spec`` does not read ``compute_dtype``): it is served
  by the f32 stack (its plain version on the CPU), the same as the f32
  model's, and trains through the bf16 chain.
* ``matmul_precision="bfloat16"``: the CPU computes f32 (log p bit for
  bit the f32 model's); the helper's rounding, forced on, gives products
  of bf16-rounded operands summed in f32, and restores the TF32 flags.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import close, flag_parity, normal, to_numpy, uniform

from nf_tpu.core import Ctx
from nf_tpu.nets import layers as jl

EVAL = Ctx(rng=None, train=False)
BF16_MODULE_REL = 2e-3


def _module_pair(jmod, tmod, x):
    from nf_tpu_torch.convert import load_jax_variables

    var = to_numpy(jmod.init(jax.random.PRNGKey(1)))
    load_jax_variables(tmod, var)
    jy = jmod.apply(var, x, EVAL)[0]
    with torch.no_grad():
        ty = tmod(torch.from_numpy(x))
    assert jy.dtype == jnp.bfloat16 and ty.dtype == torch.bfloat16
    jy = np.asarray(jy.astype(jnp.float32))
    close(ty.float(), jy, BF16_MODULE_REL * np.abs(jy).max())
    return jy


@pytest.mark.parametrize("kind", ["dense", "conv3x3", "conv1x1"])
def test_bf16_layers_match_nf_tpu(kind):
    from nf_tpu_torch.nets import layers as tl

    if kind == "dense":
        jmod, x = jl.Dense(16, 24, compute_dtype="bfloat16"), normal(0, (64, 16))
        tmod = tl.Dense(16, 24, device="cpu", compute_dtype="bfloat16")
    else:
        k = 3 if kind == "conv3x3" else 1
        jmod, x = jl.Conv2d(4, 16, k, compute_dtype="bfloat16"), normal(0, (8, 16, 16, 4))
        tmod = tl.Conv2d(4, 16, k, device="cpu", compute_dtype="bfloat16")
    jy = _module_pair(jmod, tmod, x)
    f32 = tl.Dense(16, 24, device="cpu") if kind == "dense" else tl.Conv2d(4, 16, k,
                                                                          device="cpu")
    f32.load_state_dict(tmod.state_dict())
    with torch.no_grad():
        y32 = f32(torch.from_numpy(x)).numpy()
    assert np.abs(y32 - jy).max() > 1e-4 * np.abs(jy).max()      # bf16 for real
    assert all(p.dtype == torch.float32 for p in tmod.parameters())


@pytest.mark.parametrize("name,dims,layers", [("realnvp", (16, 16, 1), 2),
                                              ("glow", (8, 8, 3), 2)],
                         ids=["realnvp-16x16x1", "glow-8x8x3"])
def test_bf16_image_models_match_nf_tpu(name, dims, layers):
    _, var, tm = flag_parity(name, dims, "image", 3e-4, layers=layers, base_filters=8,
                             batch=16, eager=True, compute_dtype="bfloat16")
    assert all(p.dtype == torch.float32 for p in tm.parameters())
    nets = [m for m in tm.modules() if type(m).__name__ in ("Dense", "Conv2d")]
    assert nets and all(m.compute_dtype == torch.bfloat16 for m in nets)
    _, _, t32 = flag_parity(name, dims, "image", 3e-4, layers=layers, base_filters=8,
                            batch=16, logp=False)
    t32.load_state_dict(tm.state_dict())
    x = torch.from_numpy(uniform(7, (16,) + dims))
    lp, lp32 = tm.eval_program().log_prob(x), t32.eval_program().log_prob(x)
    assert float((lp - lp32).abs().max()) > 1e-3       # bf16 for real, f32 not


@pytest.mark.parametrize("name,kw", [
    ("flow++", dict(mixtures=2)), ("maf", {}), ("planar", {}), ("resflow", dict(logdet="exact")),
    ("ffjord", dict(trace="exact", layers=1))],
    ids=["flowpp", "maf", "planar", "resflow", "ffjord"])
def test_other_families_ignore_compute_dtype(name, kw):
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.models import build_model

    kw = {"layers": 2, "base_filters": 8, **kw}
    _, _, tm = flag_parity(name, (2,), "2d", 1e-4, logp=name != "resflow",
                           compute_dtype="bfloat16", **kw)
    assert not any(getattr(m, "compute_dtype", None) is not None for m in tm.modules())
    ref = build_model(name, (2,), "2d", NetworkConfig(name=name, **kw), device="cpu")
    ref.load_state_dict(tm.state_dict())
    x = torch.from_numpy(normal(3, (16, 2)))
    assert torch.equal(tm.eval_program().log_prob(x), ref.eval_program().log_prob(x))


def test_bf16_2d_model_keeps_its_fused_spec():
    from nf_tpu_torch.ops.cuda.fused_stack import extract_stack_spec

    # nf_tpu serves its chain off a TPU, so its program is no reference here
    jm, var, tm = flag_parity("realnvp", (2,), "2d", logp=False, layers=4, base_filters=8,
                              compute_dtype="bfloat16")
    assert jm._fused_spec is not None
    assert extract_stack_spec(tm.bijector, tm.dims) is not None
    prog = tm.eval_program()
    assert prog.stack is not None
    _, _, t32 = flag_parity("realnvp", (2,), "2d", 1e-4, layers=4, base_filters=8, logp=False)
    t32.load_state_dict(tm.state_dict())
    x = torch.from_numpy(normal(4, (64, 2)))
    assert torch.equal(prog.log_prob(x), t32.eval_program().log_prob(x))
    # training runs the chain, whose conditioners compute in bf16
    tm.train()
    t32.train()
    assert float((tm.log_prob(x) - t32.log_prob(x)).detach().abs().max()) > 1e-4


@pytest.mark.parametrize("name,dims,datatype", [("realnvp", (2,), "2d"),
                                                ("glow", (8, 8, 3), "image")])
def test_matmul_precision_bf16_is_f32_on_the_cpu(name, dims, datatype):
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.models import build_model
    from nf_tpu_torch.ops import precision as pm

    kw = dict(name=name, layers=2, base_filters=8)
    ref = build_model(name, dims, datatype, NetworkConfig(**kw), device="cpu")
    try:
        bf = build_model(name, dims, datatype,
                         NetworkConfig(matmul_precision="bfloat16", **kw), device="cpu")
        assert pm.matmul_precision() == "bfloat16"
        bf.load_state_dict(ref.state_dict())
        x = (uniform(5, (8,) + dims) if datatype == "image" else normal(5, (8,) + dims))
        x = torch.from_numpy(x)
        assert torch.equal(bf.eval_program().log_prob(x), ref.eval_program().log_prob(x))
    finally:
        pm.set_matmul_precision(None)
    assert pm.matmul_precision() == "float32"
    with pytest.raises(ValueError, match="matmul_precision"):
        pm.set_matmul_precision("tf32")


def test_precision_helper_rounds_operands(monkeypatch):
    """Forced on (the card's path), a product takes bf16-rounded operands
    and sums in f32, returns f32, and leaves the TF32 flags as it found
    them."""
    import torch.nn.functional as F

    from nf_tpu_torch.ops import precision as pm

    monkeypatch.setattr(pm, "_reduced", lambda x: True)
    x, w, b = (torch.from_numpy(normal(s, shape)) for s, shape in
               ((0, (32, 48)), (1, (24, 48)), (2, (24,))))
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    r = lambda t: t.to(torch.bfloat16).float()  # noqa: E731
    y = pm.linear(x, w, b)
    assert y.dtype == torch.float32
    torch.testing.assert_close(y, F.linear(r(x), r(w), b), rtol=1e-6, atol=1e-6)
    assert float((y - F.linear(x, w, b)).abs().max()) > 1e-3
    torch.testing.assert_close(pm.matmul(x, w.T), r(x) @ r(w).T, rtol=1e-6, atol=1e-6)
    xi, k = torch.from_numpy(normal(3, (2, 4, 8, 8))), torch.from_numpy(normal(4, (6, 4, 3, 3)))
    torch.testing.assert_close(pm.conv2d(xi, k, padding=1), F.conv2d(r(xi), r(k), padding=1),
                               rtol=1e-6, atol=1e-6)
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == flags
