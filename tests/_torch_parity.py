"""Shared set-up of the port's parity tests: the same model built by
``nf_tpu`` (JAX, CPU) and by ``nf_tpu_torch`` (PyTorch, CPU), with the JAX
variables carried across, and inputs made with numpy."""
from __future__ import annotations

import jax
import numpy as np
import torch

torch.set_num_threads(1)


def to_numpy(var):
    return jax.tree.map(np.asarray, var)


def normal(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    return (np.random.default_rng(seed).standard_normal(shape) * scale
            ).astype(np.float32)


def jax_model(name: str, D: int, layers: int, filters: int, seed: int = 0,
              batch: int = 64, mixtures: int = 4, logdet: str = "unbias",
              spnorm_coeff: float = 0.9):
    """An nf_tpu density model after its data-dependent init (ActNorm; for
    ResFlow also one spectral-norm power iteration) and with any
    batch-norm running statistics moved off their init values (as
    tests/test_pallas.py does), so the folding of those statistics has
    teeth.  Returns (model, numpy var)."""
    from nf_tpu.config import NetworkConfig
    from nf_tpu.core import Ctx
    from nf_tpu.models import build_model

    cfg = NetworkConfig(name=name, layers=layers, base_filters=filters,
                        mixtures=mixtures, logdet=logdet, spnorm_coeff=spnorm_coeff)
    model = build_model(name, (D,), datatype="2d", cfg=cfg)
    rng = jax.random.PRNGKey(seed)
    var = model.init(rng)
    x = normal(seed + 100, (batch, D))
    var = model.data_dependent_init(var, x * 1.5 + 0.3)
    if name in ("realnvp", "glow"):
        ctx_t = Ctx(rng=jax.random.fold_in(rng, 2), train=True)
        fwd = jax.jit(lambda v, y: model.bijector.forward(v, y, ctx_t)[2])
        for _ in range(3):
            var = {"params": var["params"], "state": fwd(var, x * 1.3)}
    return model, to_numpy(var)


def torch_model(name: str, D: int, layers: int, filters: int, var=None,
                mixtures: int = 4, logdet: str = "unbias", spnorm_coeff: float = 0.9):
    """The port's density model on the CPU, with ``var`` (an nf_tpu
    variables pytree of numpy arrays) loaded when given."""
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.convert import load_jax_variables
    from nf_tpu_torch.models import build_model

    cfg = NetworkConfig(name=name, layers=layers, base_filters=filters,
                        mixtures=mixtures, logdet=logdet, spnorm_coeff=spnorm_coeff)
    model = build_model(name, (D,), "2d", cfg, device="cpu")
    if var is not None:
        load_jax_variables(model, var)
    return model


def uniform(seed: int, shape, low: float = 0.05, high: float = 0.95) -> np.ndarray:
    """Pixels away from the Logit edges, as bench.py makes its batches."""
    return np.random.default_rng(seed).uniform(low, high, shape).astype(np.float32)


def jax_image_model(dims=(16, 16, 1), layers: int = 1, filters: int = 8, seed: int = 0,
                    batch: int = 16, train_passes: int = 3):
    """nf_tpu's image RealNVP after its data-dependent init and
    ``train_passes`` train-mode passes, which move every batch-norm
    running statistic off its init value.  Returns (model, numpy var)."""
    from nf_tpu.config import NetworkConfig
    from nf_tpu.core import Ctx
    from nf_tpu.models import build_model

    cfg = NetworkConfig(name="realnvp", layers=layers, base_filters=filters)
    model = build_model("realnvp", dims, datatype="image", cfg=cfg)
    var = model.init(jax.random.PRNGKey(seed))
    x = uniform(seed + 100, (batch,) + tuple(dims))
    var = model.data_dependent_init(var, x)
    ctx_t = Ctx(rng=None, train=True)
    fwd = jax.jit(lambda v, y: model.bijector.forward(v, y, ctx_t)[2])
    for i in range(train_passes):
        var = {"params": var["params"], "state": fwd(var, uniform(seed + 101 + i, x.shape))}
    return model, to_numpy(var)


def torch_image_model(dims=(16, 16, 1), layers: int = 1, filters: int = 8, var=None):
    """The port's image RealNVP on the CPU, with ``var`` loaded when given."""
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.convert import load_jax_variables
    from nf_tpu_torch.models import build_model

    cfg = NetworkConfig(name="realnvp", layers=layers, base_filters=filters)
    model = build_model("realnvp", dims, "image", cfg, device="cpu")
    if var is not None:
        load_jax_variables(model, var)
    return model


def jax_realnvp(D: int, layers: int, filters: int, seed: int = 0, batch: int = 64):
    return jax_model("realnvp", D, layers, filters, seed, batch)


def torch_realnvp(D: int, layers: int, filters: int, var=None):
    return torch_model("realnvp", D, layers, filters, var)


def nf_unbias_probes(B: int, D: int):
    """nf_tpu's serving 'unbias' draws (PRNGKey(0), the key every eval block
    uses) in the port's layout: (V (S, B, D), n_terms (S,) int32)."""
    from nf_tpu.ops.pallas.fused_resflow import draw_unbias_probes

    V, thr, _ = draw_unbias_probes(B, D)
    return (torch.from_numpy(np.asarray(V).transpose(1, 2, 0).copy()),
            torch.from_numpy(np.asarray(thr)[0, :, 0].astype(np.int32)))


def nf_fixed_probes(B: int, D: int):
    """nf_tpu's serving 'fixed' draws from PRNGKey(0), port layout."""
    keys = jax.random.split(jax.random.PRNGKey(0), 4)
    return torch.from_numpy(np.stack([np.asarray(jax.random.normal(k, (B, D)))
                                      for k in keys])), None


def as_numpy(a):
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def close(a, b, atol, rtol=0.0):
    np.testing.assert_allclose(as_numpy(a), as_numpy(b), atol=atol, rtol=rtol)
