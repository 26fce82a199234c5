"""The port's ResFlow image branch (``allow_image``) against nf_tpu's, on
the CPU: the conv residual block, the model, and its Trainer.

Draws are nf_tpu's, injected as in test_torch_resflow_train.py: the
serving set of every eval block is PRNGKey(0)'s, of the data's shape
(``_torch_parity.nf_eval_draws``); the training sets come from each
block's key (``nf_train_draws``).

Tolerances: 2e-5 per module's output (measured up to 2.4e-7), 1e-4 for
a log-det series and an inverse, 3e-4 for image log-densities; the
Trainer's as ``_torch_parity.resflow_trainer_parity`` states them.

* ``InvertibleResConv2d`` in eval (forward, the fixed-point inverse) and
  in training (output, log-det and every u / v after the pass);
* the model at 8x8x1 (2 blocks, base_filters 8): without the opt-in it
  raises nf_tpu's message; with it the chain's structure (Logit,
  Squeeze2d, [ActNorm(4C), InvertibleResConv2d] x 2, Unsqueeze2d), no
  fused spec (``extract_resflow_spec`` is None), and the EvalProgram's
  forward, inverse and log p against nf_tpu's; a (S, B, D) probe set is
  the same draw as its (S, B, H, W, C) form, and the serving program
  draws what each eager block draws;
* three ``Trainer`` steps against nf_tpu's, then the trained state served.
"""
import jax
import numpy as np
import pytest
import torch
from _torch_parity import (close, jax_resflow, nf_eval_draws, nf_train_draws, normal,
                           resflow_block_pair, resflow_trainer_parity, to_numpy,
                           torch_resflow, uniform)

from nf_tpu.core import Ctx
from nf_tpu_torch.convert import load_jax_variables

ATOL = 2e-5
SERIES_ATOL = 1e-4
IMAGE_LOGP_ATOL = 3e-4
EVAL = Ctx(rng=None, train=False)
IMG_DIMS = (8, 8, 1)


def _t(a):
    return torch.from_numpy(np.array(a))


def test_invertible_res_conv2d_eval():
    jb, var, tb, shape = resflow_block_pair(conv=True, coeff=0.9, seed=5)
    x = normal(8, shape, 1.2)
    probes = nf_eval_draws(shape)
    jy, jld, _ = jb.forward(var, x, EVAL)
    jx, jldi, _ = jb.inverse(var, jy, EVAL)
    with torch.no_grad():
        y, ld = tb.eval()(_t(x), probes)
        xi, ldi = tb.inverse(_t(jy), probes)
    close(y, jy, ATOL)
    close(ld, jld, SERIES_ATOL)
    close(xi, jx, ATOL)
    close(ldi, jldi, SERIES_ATOL)


def test_invertible_res_conv2d_training():
    jb, var, tb, shape = resflow_block_pair(conv=True, coeff=0.9, seed=5)
    before = [b.clone() for b in tb.buffers()]
    x = normal(8, shape, 1.2)
    key = jax.random.PRNGKey(12)
    jy, jld, jst = jb.forward(var, x, Ctx(rng=key, train=True))
    tb.train().injected_train_probes = nf_train_draws(key, shape)
    y, ld = tb(_t(x))
    close(y.detach(), jy, ATOL)
    close(ld.detach(), jld, ATOL)
    after = resflow_block_pair(conv=True, coeff=0.9, seed=5)[2]
    load_jax_variables(after, {"params": var["params"], "state": to_numpy(jst)})
    for got, want, start in zip(tb.buffers(), after.buffers(), before):
        close(got, want, ATOL)
        assert not torch.equal(got, start)


def test_image_model_matches_nf_tpu():
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.models import build_model
    from nf_tpu_torch.ops.cuda.fused_resflow import extract_resflow_spec

    with pytest.raises(NotImplementedError, match="allow_image"):
        build_model("resflow", IMG_DIMS, "image", NetworkConfig(name="resflow"), device="cpu")
    jm, var = jax_resflow(IMG_DIMS, "image", 2, 8)
    x = uniform(20, (12,) + IMG_DIMS)
    var = to_numpy(jm.data_dependent_init(var, x))
    tm = torch_resflow(IMG_DIMS, "image", 2, 8, var)
    kinds = [type(m).__name__ for m in tm.bijector.layers]
    assert kinds == ["Logit", "Squeeze2d"] + ["ActNorm", "InvertibleResBlock"] * 2 + [
        "Unsqueeze2d"]
    conv = tm.bijector.layers[3].g_net.layers[0]
    assert conv.spatial == (4, 4) and conv.u.shape == (1, 4, 4, 8)
    assert extract_resflow_spec(tm.bijector, tm.dims) is None

    probes = nf_eval_draws((12, 4, 4, 4))
    jprog = jm.eval_program(var)
    prog = tm.eval_program(probes=probes)
    assert prog.stack is None
    close(prog.log_prob(_t(x)), jprog.log_prob(x), IMAGE_LOGP_ATOL)
    jz, jld = jprog.forward(x)
    z, ld = prog.forward(_t(x))
    close(z, jz, SERIES_ATOL)
    close(ld, jld, IMAGE_LOGP_ATOL)
    jxr, jldi = jprog.inverse(jz)
    xr, ldi = prog.inverse(_t(jz))
    close(xr, jxr, SERIES_ATOL)
    close(ldi, jldi, IMAGE_LOGP_ATOL)
    close(xr, x, 1e-3)
    # the (S, B, D) form of the same draw
    flat = (probes[0].reshape(4, 12, -1), probes[1])
    close(tm.eval_program(probes=flat).log_prob(_t(x)), prog.log_prob(_t(x)), 0.0)
    # the serving set: what each block draws alone in the eager chain
    served = tm.eval_program()
    with torch.no_grad():
        _, ld_chain = tm(_t(x))
    close(served.forward(_t(x))[1], ld_chain, 0.0)


def test_trainer_image_matches_nf_tpu():
    batches = np.stack([uniform(40 + k, (8,) + IMG_DIMS) for k in range(4)])
    prog = resflow_trainer_parity(IMG_DIMS, "image", 2, 8, batches, IMAGE_LOGP_ATOL)
    assert prog.stack is None
