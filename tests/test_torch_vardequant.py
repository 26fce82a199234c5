"""The port's variational dequantization (Flow++) against nf_tpu's, on the
CPU.

nf_tpu draws the dequantization noise eps from JAX keys and the port from
a torch generator, so the comparisons inject nf_tpu's draw: ``_flow``
takes eps as an argument, and ``VariationalDequant.injected_eps`` replaces
a forward's draw; in a model the head is chain child 0, so its eps is
``normal(fold_in(key, 0), x.shape)``.

* ``_flow`` (the conditional flow eps -> (u, log q(u | x))) at 8x8x1 and
  4x4x3, base_filters 8, with nf_tpu's variables carried across and every
  parameter moved off its init: u within 2e-5 and log q (a sum of 3 x D
  terms near 30) within 1e-4 (measured 2.3e-5, f32's 1e-6 of it), in
  eval and train mode, and in train mode the three ConvNets' running
  statistics within 2e-5;
* the flowpp image model at 8x8x1 with ``var_dequant`` (1 layer,
  base_filters 8, mixtures 2): the head comes before the Logit, and
  log p with a generator within 3e-4 of nf_tpu's with a key (image
  log-densities; the ELBO's -D log 256 term is -355 nats); its inverse
  passes y through;
* without a generator the module, the model's forward and an
  ``EvalProgram`` raise ``ValueError``, as nf_tpu's eval program does;
* ``data_dependent_init`` with a generator: the same state as nf_tpu's
  with its key's draw injected (ActNorm and every running statistic
  within 2e-5), and the port's own draws repeat per generator seed.
"""
import functools
import math

import jax
import numpy as np
import pytest
import torch
from _torch_parity import close, normal, to_numpy, uniform

from nf_tpu.bijectors import vardequant as jvd
from nf_tpu.core import Ctx
from nf_tpu_torch.bijectors import vardequant as tvd
from nf_tpu_torch.convert import load_jax_variables

KEY = jax.random.PRNGKey(3)


def _t(a):
    return torch.from_numpy(np.array(a))


def _moved(var, seed, scale=0.05):
    leaves, tree = jax.tree.flatten(to_numpy(var)["params"])
    leaves = [np.asarray(l) + normal(seed + i, np.shape(l), scale)
              for i, l in enumerate(leaves)]
    return {"params": jax.tree.unflatten(tree, leaves), "state": to_numpy(var)["state"]}


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("dims", [(8, 8, 1), (4, 4, 3)])
def test_flow_matches_nf_tpu(dims, train):
    jh = jvd.VariationalDequant(dims, base_filters=8)
    var = _moved(jh.init(jax.random.PRNGKey(1)), 10)
    th = tvd.VariationalDequant(dims, base_filters=8, device="cpu")
    load_jax_variables(th, var)
    for m, odd in zip((th.mask0, th.mask1), (False, True)):
        close(m, jvd._checker_mask(*dims, odd), 0.0)
    x = uniform(20, (6,) + dims, 0.0, 1.0)
    eps = normal(21, x.shape)
    th.train(train)
    u, logq = th._flow(_t(x), _t(eps))
    ju, jlogq, jstate = jh._flow(var, x, eps, Ctx(rng=None, train=train))
    close(u.detach(), ju, 2e-5)
    close(logq.detach(), jlogq, 1e-4)
    if train:
        want = tvd.VariationalDequant(dims, base_filters=8, device="cpu")
        load_jax_variables(want, {"params": var["params"], "state": to_numpy(jstate)})
        for name, buf in th.named_buffers():
            close(buf, want.get_buffer(name), 2e-5)


MODEL = dict(name="flow++", layers=1, base_filters=8, mixtures=2, var_dequant=True)


@functools.cache
def _jax_model(dims):
    """nf_tpu's model and its init (eager: about 20 s on a CPU, so once)."""
    from nf_tpu.config import NetworkConfig as JNetworkConfig
    from nf_tpu.models import build_model as jbuild

    jm = jbuild("flow++", dims, datatype="image", cfg=JNetworkConfig(**MODEL))
    return jm, to_numpy(jm.init(jax.random.PRNGKey(0)))


def _models(dims):
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.models import build_model

    tm = build_model("flow++", dims, "image", NetworkConfig(**MODEL), device="cpu")
    return _jax_model(dims) + (tm,)


def test_model_log_prob_matches_nf_tpu():
    from nf_tpu_torch.bijectors.elementwise import Logit

    dims = (8, 8, 1)
    jm, var, tm = _models(dims)
    var = _moved(jm.data_dependent_init(var, uniform(30, (16,) + dims), rng=KEY), 31)
    load_jax_variables(tm, var)
    head, logit = tm.bijector.layers[:2]
    assert isinstance(head, tvd.VariationalDequant) and isinstance(logit, Logit)
    x = uniform(32, (8,) + dims, 0.0, 1.0)
    head.injected_eps = _t(jax.random.normal(jax.random.fold_in(KEY, 0), x.shape))
    tm.eval()
    with torch.no_grad():
        lp = tm.log_prob(_t(x), torch.Generator().manual_seed(0))
    jlp = jax.jit(lambda v, y: jm.log_prob(v, y, Ctx(rng=KEY, train=False))[0])(var, x)
    close(lp, jlp, 3e-4)
    with torch.no_grad():
        y, ld = head.inverse(_t(x))
    assert torch.equal(y, _t(x)) and not ld.any()
    d = math.prod(dims)
    head.injected_eps = None
    with torch.no_grad():
        _, ld = head(_t(x), torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(ld).all()) and float(ld.max()) < -d * math.log(256) + d


def test_raises_without_a_generator():
    dims = (8, 8, 1)
    jm, var, tm = _models(dims)
    x = uniform(40, (4,) + dims)
    with pytest.raises(ValueError, match="generator"):
        tm.bijector.layers[0](_t(x))
    with pytest.raises(ValueError, match="generator"):
        tm.log_prob(_t(x))
    prog = tm.eval_program()
    with pytest.raises(ValueError, match="generator"):
        prog.forward(_t(x))
    with pytest.raises(ValueError, match="generator"):
        prog.log_prob(_t(x))
    with pytest.raises(ValueError, match="rng"):
        jm.eval_program(var).log_prob(x)


def test_data_dependent_init_with_generator():
    dims = (8, 8, 1)
    jm, var, tm = _models(dims)
    load_jax_variables(tm, to_numpy(var))
    batch = uniform(50, (16,) + dims, 0.0, 1.0)
    jvar = to_numpy(jm.data_dependent_init(var, batch, rng=KEY))
    head = tm.bijector.layers[0]
    head.injected_eps = _t(jax.random.normal(jax.random.fold_in(KEY, 0), batch.shape))
    tm.data_dependent_init(_t(batch), torch.Generator().manual_seed(5))
    want = {k: v.clone() for k, v in tm.state_dict().items()}
    ref = _models(dims)[2]
    load_jax_variables(ref, jvar)
    for name, buf in ref.state_dict().items():
        close(want[name].float(), buf.float(), 2e-5)
    # the port's own draws: the same generator seed gives the same state
    head.injected_eps = None
    states = []
    for _ in range(2):
        load_jax_variables(tm, to_numpy(var))
        tm.data_dependent_init(_t(batch), torch.Generator().manual_seed(5))
        states.append({k: v.clone() for k, v in tm.state_dict().items()})
    for k in states[0]:
        assert torch.equal(states[0][k], states[1][k]), k
    key = "bijector.layers.0.net_couplings.0.layers.3.running_mean"
    assert not torch.equal(states[0][key], want[key])
