"""The port's ResFlow training against nf_tpu's, on the CPU: the spectral
norms in train mode, the memory-saved Function and the 2-D Trainer
(the image branch: test_torch_resflow_image.py).

nf_tpu draws a training block's series from JAX keys, the port from torch
generators, so every comparison hands the port nf_tpu's draws
(``InvertibleResBlock.injected_train_probes``).  nf_tpu's key path: the
block at chain index i of update ``step`` takes ``key = fold_in(fold_in(
PRNGKey(seed), step), i)`` (the data-dependent init ``fold_in(PRNGKey(seed),
1)`` in place of the step key), ``k_val, k_grad = split(key)``; the value
draw is ``split(k_val, 1)[0] -> (kn, kv)``, ``n = 1 + geometric(kn)``,
``v = normal(kv, x.shape)``, and ``k_grad -> (kn, kv)`` gives the Neumann
draw the same way (``_torch_parity.nf_train_draws``).  The block-level
and Trainer matches below confirm that path.

Tolerances: 2e-5 per module (measured up to 1e-6), 1e-4 per program; the
Trainer's as ``_torch_parity.resflow_trainer_parity`` states them.

* ``SpectralNormDense`` (sigma capped and not) and ``SpectralNormConv2d``
  (the conv operator with ``spatial``, and the matricized fallback):
  output and u / v after a training pass, and the eval output after it;
* ``iresblock_forward``: value and gradients with respect to x, the
  spectral norms' weights and biases and the LipSwish betas against
  nf_tpu's ``custom_vjp``, a dense g and a conv g, under a loss that
  weights each sample's log-det differently; at coeff 0.9 (sigma above
  it: the scale below 1, the gradient through sigma) and coeff 50 (the
  scale 1 or more);
* the bytes the Function keeps for backward do not grow with the series
  lengths (no series graph kept);
* ``draw_train_probes``' structure and the two series' weights;
* three ``Trainer`` steps of ResFlow 2-D against nf_tpu's, then the
  trained state served by the port's EvalProgram (the fused plain
  version) against nf_tpu's.
"""
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_parity import (close, nf_train_draws, normal, resflow_block_pair,
                           resflow_trainer_parity, to_numpy)

from nf_tpu.core import Ctx
from nf_tpu.ops import estimators as jest
from nf_tpu_torch.convert import load_jax_variables
from nf_tpu_torch.ops import estimators as test_

ATOL = 2e-5
EVAL = Ctx(rng=None, train=False)
TRAIN = Ctx(rng=None, train=True)


def _t(a):
    return torch.from_numpy(np.array(a))


def _loaded(module, var):
    load_jax_variables(module, to_numpy(var))
    return module


# --------------------------------------------------------------- spectral norms
@pytest.mark.parametrize("coeff", [0.5, 50.0], ids=["capped", "uncapped"])
def test_spectral_norm_dense_training(coeff):
    from nf_tpu.nets.spectral import SpectralNormDense as JSN
    from nf_tpu_torch.nets.spectral import SpectralNormDense

    js = JSN(3, 7, coeff=coeff)
    var = to_numpy(js.init(jax.random.PRNGKey(1)))
    # u / v off the converged pair, so the iteration moves them visibly
    var["state"]["u"] = normal(4, (7,))
    var["state"]["v"] = normal(5, (3,))
    ts = _loaded(SpectralNormDense(3, 7, coeff=coeff, device="cpu"), var).train()
    x = normal(1, (19, 3), 1.5)
    jy, jst = js.apply(var, x, TRAIN)
    close(ts(_t(x)).detach(), jy, ATOL)
    close(ts.u, jst["u"], ATOL)
    close(ts.v, jst["v"], ATOL)
    assert not np.allclose(jst["u"], var["state"]["u"])
    close(ts.eval()(_t(x)).detach(),
          js.apply({"params": var["params"], "state": jst}, x, EVAL)[0], ATOL)


@pytest.mark.parametrize("spatial", [(4, 4), None], ids=["operator", "matricized"])
def test_spectral_norm_conv2d(spatial):
    from nf_tpu.nets.spectral import SpectralNormConv2d as JSC
    from nf_tpu_torch.nets.spectral import SpectralNormConv2d

    js = JSC(2, 5, coeff=0.9, spatial=spatial)
    var = to_numpy(js.init(jax.random.PRNGKey(2)))
    ts = _loaded(SpectralNormConv2d(2, 5, coeff=0.9, spatial=spatial, device="cpu"), var)
    assert ts.w_bar.shape == (3, 3, 2, 5) and ts.u.shape == var["state"]["u"].shape
    x = normal(3, (6, 4, 4, 2), 1.5)
    close(ts.eval()(_t(x)).detach(), js.apply(var, x, EVAL)[0], ATOL)
    var["state"]["u"] = normal(6, var["state"]["u"].shape)
    var["state"]["v"] = normal(7, var["state"]["v"].shape)
    _loaded(ts, var)
    jy, jst = js.apply(var, x, TRAIN)
    close(ts.train()(_t(x)).detach(), jy, ATOL)
    close(ts.u, jst["u"], ATOL)
    close(ts.v, jst["v"], ATOL)
    close(ts.eval()(_t(x)).detach(),
          js.apply({"params": var["params"], "state": jst}, x, EVAL)[0], ATOL)

    # the port's own init warm-starts u / v (10 iterations): one more moves
    # them little
    ts.init(torch.Generator().manual_seed(0))
    u, v = ts.u.clone(), ts.v.clone()
    ts.power_iterate()
    assert float((ts.u - u).abs().max()) < 0.05 and float((ts.v - v).abs().max()) < 0.05
    # Module.to reaches the parameters and buffers (float64 parity runs use it)
    y32 = ts.eval()(_t(x)).detach()
    close(ts.to(torch.float64)(_t(x).double()).detach(), y32, 1e-5)


def test_spectral_norm_conv2d_wants_an_odd_kernel():
    from nf_tpu_torch.nets.spectral import SpectralNormConv2d

    with pytest.raises(ValueError, match="odd"):
        SpectralNormConv2d(2, 2, kernel_size=2, device="cpu")


# ------------------------------------------------- the memory-saved Function
@pytest.mark.parametrize("coeff", [0.9, 50.0], ids=["scale<1", "scale>=1"])
@pytest.mark.parametrize("conv", [False, True], ids=["dense", "conv"])
def test_iresblock_forward_matches_custom_vjp(conv, coeff):
    jb, var, tb, shape = resflow_block_pair(conv, coeff)
    sns = tb.g_net.layers[::2]
    capped = [not torch.equal(m.weight(), m.w_bar) for m in sns]
    assert any(capped) if coeff < 1 else not any(capped)
    key = jax.random.PRNGKey(11)
    x = normal(1, shape, 1.3)
    wts = np.random.default_rng(0).uniform(0.2, 2.0, shape[0]).astype(np.float32)
    r = normal(2, shape)
    g_apply = jb._g_apply_pure(var["state"]["g"])

    def jloss(params, xx):
        g, ld = jest.iresblock_forward(g_apply, params, xx, key)
        return jnp.sum(wts * ld) + jnp.sum(r * g), (g, ld)

    value_and_grad = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True))
    (_, (jg, jld)), (jgp, jgx) = value_and_grad(var["params"]["g"], x)

    params = list(tb.g_net.parameters())
    xt = _t(x).requires_grad_()
    g, ld = test_.iresblock_forward(tb._g_eval, params, xt, nf_train_draws(key, shape))
    close(g.detach(), jg, ATOL)
    close(ld.detach(), jld, ATOL)
    ((_t(wts) * ld).sum() + (_t(r) * g).sum()).backward()
    close(xt.grad, jgx, ATOL)
    want = _loaded(resflow_block_pair(conv, coeff)[2],
                   {"params": {"g": jgp}, "state": var["state"]})
    got = dict(tb.named_parameters())
    for name, p in want.named_parameters():
        close(got[name].grad, p.detach(), ATOL, 1e-5)
    assert all(p.grad.abs().max() > 0 for p in params)


class _Held:
    """A saved tensor as the graph keeps it, weakly referable."""
    __slots__ = ("t", "__weakref__")


def test_function_keeps_no_series_graph():
    _, _, tb, shape = resflow_block_pair(conv=True, coeff=0.9)
    x = _t(normal(1, shape)).requires_grad_()
    v = _t(normal(2, shape))
    kept = {}
    for n in (2, 24):
        held = []

        def pack(t):
            h = _Held()
            h.t = t.detach()    # a saved output kept with its grad_fn would be a cycle
            held.append(weakref.ref(h))
            return h

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda h: h.t):
            g, ld = test_.iresblock_forward(tb._g_eval, list(tb.g_net.parameters()), x,
                                            ((n, v), (n, v)))
        # what the graph still holds after the forward: the local graph of g
        # that formed the series is gone
        kept[n] = sum(h.t.numel() * h.t.element_size() for h in (r() for r in held)
                      if h is not None)
        (g.sum() + ld.sum()).backward()
    # x, the Neumann probe u and v: three tensors of x's shape
    assert kept[2] == kept[24] == 3 * x.numel() * 4, kept


def test_train_draws_have_nf_tpus_structure():
    g = torch.Generator().manual_seed(0)
    (n_val, v_val), (n_grad, v_grad) = test_.draw_train_probes((5, 4, 4, 2), g)
    assert isinstance(n_val, int) and isinstance(n_grad, int)
    assert 2 <= n_val <= 33 and 2 <= n_grad <= 33
    assert v_val.shape == v_grad.shape == (5, 4, 4, 2) and not torch.equal(v_val, v_grad)
    again = test_.draw_train_probes((5, 4, 4, 2), torch.Generator().manual_seed(0))
    assert again[0][0] == n_val and torch.equal(again[1][1], v_grad)
    # the Neumann weights carry no 1/k, the log-det's do
    assert [test_.neumann_coefficient(k) for k in (1, 2, 3, 4)] == [-1.0, 1.0, -2.0, 4.0]
    assert [test_.roulette_coefficient(k, 0.5, 1) for k in (1, 2, 3)] == [1.0, -0.5, 2.0 / 3]


# --------------------------------------------------------------- the Trainer
def test_trainer_density_matches_nf_tpu():
    from nf_tpu_torch.ops.cuda import fused_resflow as tfr

    batches = np.stack([normal(30 + k, (64, 2)) * 1.3 + 0.2 for k in range(4)])
    prog = resflow_trainer_parity((2,), "2d", 3, 16, batches, 1e-4)
    assert isinstance(prog.stack, tfr.PackedResFlow)
