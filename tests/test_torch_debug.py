"""``run.debug``'s probes in the port against nf_tpu's, on the CPU.

``check_chain`` probes every layer of a model; nf_tpu wraps each in a
``CheckedBijector``, which hides the layers from its fused matchers, so a
checked model's ``eval_program`` runs the probed chain and a non-finite
row raises ``FloatingPointError`` naming the first layer that made it.
The port tags the layers in place, and its ``EvalProgram`` takes the
eager chain for a probed model, so the served program raises the same
message (nf_tpu's inside a ``JaxRuntimeError``).  On finite rows the
probed programs agree to the programs' 1e-4 (ResFlow with nf_tpu's
serving probes injected); untagged, the models keep their fused path.
``CheckedBijector`` itself: the port's wrapper around an
``AffineCoupling`` loads nf_tpu's variables, whose tree has no level of
the wrapper's, and writes them back so.
"""
import jax
import numpy as np
import pytest
import torch
from _torch_parity import close, jax_model, nf_unbias_probes, normal, to_numpy, torch_model

FAMILIES = ("realnvp", "glow", "flow++", "resflow")
ATOL = 1e-4
ROWS = np.array([[0.1, 0.2], [np.nan, 1.0]], np.float32)


def _models(name, checked):
    from nf_tpu.utils.debug import check_chain as nf_check_chain

    from nf_tpu_torch.utils.debug import check_chain

    jmodel, var = jax_model(name, 2, 4, 8, seed=5, batch=64)
    tmodel = torch_model(name, 2, 4, 8, var)
    if checked:
        jmodel.bijector = nf_check_chain(jmodel.bijector)
        check_chain(tmodel.bijector)
    return jmodel, var, tmodel


def _program(tmodel, name, batch):
    return tmodel.eval_program(probes=nf_unbias_probes(batch, 2) if name == "resflow" else None)


@pytest.mark.parametrize("name", FAMILIES)
def test_checked_program_raises_on_a_nan_row(name):
    jmodel, var, tmodel = _models(name, checked=True)
    assert jmodel._fused_spec is None
    prog = _program(tmodel, name, len(ROWS))
    assert prog.stack is None
    layer0 = type(tmodel.bijector.layers[0]).__name__
    assert layer0 == type(jmodel.bijector.layers[0].inner).__name__
    message = f"non-finite output in layer0:{layer0}.forward: tensor_bad=True"
    with pytest.raises(Exception, match=message) as nf_error:
        np.asarray(jmodel.eval_program(var).log_prob(ROWS))
    assert "FloatingPointError" in str(nf_error.value)
    with pytest.raises(FloatingPointError, match=message):
        prog.log_prob(torch.from_numpy(ROWS))


@pytest.mark.parametrize("name", FAMILIES)
def test_checked_program_matches_nf_tpu_on_finite_rows(name):
    from nf_tpu_torch.ops.cuda import fused_flowpp, fused_resflow, fused_stack

    jmodel, var, tmodel = _models(name, checked=True)
    x = normal(11, (64, 2))
    counters = (fused_stack, fused_flowpp, fused_resflow)
    before = [dict(m.LAUNCHES) for m in counters]
    prog = _program(tmodel, name, 64)
    close(prog.log_prob(torch.from_numpy(x)), jmodel.eval_program(var).log_prob(x), ATOL)
    assert [m.LAUNCHES for m in counters] == before
    # the probed chain serves what the fused path serves
    unprobed = torch_model(name, 2, 4, 8, var)
    close(prog.log_prob(torch.from_numpy(x)),
          _program(unprobed, name, 64).log_prob(torch.from_numpy(x)), ATOL)


@pytest.mark.parametrize("name", FAMILIES)
def test_untagged_models_keep_their_fused_path(name):
    from nf_tpu_torch.models.base import fused_spec

    jmodel, var, tmodel = _models(name, checked=False)
    assert jmodel._fused_spec is not None
    prog = _program(tmodel, name, 64)
    assert prog.stack is not None
    assert type(prog.stack.spec) is type(fused_spec(tmodel.bijector, tmodel.dims))


def test_probed_inverse_names_the_last_layer():
    jmodel, var, tmodel = _models("realnvp", checked=True)
    prog = tmodel.eval_program()
    last = len(tmodel.bijector.layers) - 1
    name = type(tmodel.bijector.layers[last]).__name__
    with pytest.raises(FloatingPointError,
                       match=f"non-finite output in layer{last}:{name}.inverse"):
        prog.inverse(torch.from_numpy(ROWS))


def test_a_wrapped_layer_also_takes_the_eager_chain():
    from nf_tpu_torch.core.bijector import Chain
    from nf_tpu_torch.utils.debug import CheckedBijector

    jmodel, var, tmodel = _models("realnvp", checked=False)
    x = normal(12, (64, 2))
    want = tmodel.eval_program().log_prob(torch.from_numpy(x))
    layers = list(tmodel.bijector.layers)
    tmodel.bijector = Chain([CheckedBijector(layers[0])] + layers[1:])
    prog = tmodel.eval_program()
    assert prog.stack is None
    close(prog.log_prob(torch.from_numpy(x)), want, ATOL)
    with pytest.raises(FloatingPointError, match="non-finite output in BatchNorm.forward"):
        prog.log_prob(torch.from_numpy(ROWS))


def _coupling_pair():
    """nf_tpu's Chain([CheckedBijector(AffineCoupling)]) with perturbed
    variables, and the port's with them loaded."""
    from nf_tpu.bijectors import AffineCoupling as NfCoupling
    from nf_tpu.core import Chain as NfChain
    from nf_tpu.utils.debug import CheckedBijector as NfChecked

    from nf_tpu_torch.bijectors import AffineCoupling
    from nf_tpu_torch.convert import load_jax_variables
    from nf_tpu_torch.core import Chain
    from nf_tpu_torch.utils.debug import CheckedBijector

    jchain = NfChain([NfChecked(NfCoupling((4,), odd=True, base_filters=8))])
    var = to_numpy(jchain.init(jax.random.PRNGKey(4)))
    rng = np.random.default_rng(4)
    var = jax.tree.map(lambda a: (a + 0.1 * rng.standard_normal(a.shape)).astype(a.dtype)
                       if a.dtype == np.float32 else a, var)
    tchain = Chain([CheckedBijector(AffineCoupling((4,), odd=True, base_filters=8,
                                                   device="cpu"))])
    load_jax_variables(tchain, var)
    return jchain, var, tchain.eval()


def test_checked_bijector_matches_nf_tpu():
    from nf_tpu.core import Ctx

    jchain, var, tchain = _coupling_pair()
    ctx = Ctx(train=False)
    x = normal(13, (16, 4))
    jy, jld, _ = jchain.forward(var, x, ctx)
    with torch.no_grad():
        y, ld = tchain(torch.from_numpy(x))
        xr, ldi = tchain.inverse(y)
    close(y, jy, 1e-5)
    close(ld, jld, 1e-5)
    jx, jldi, _ = jchain.inverse(var, np.asarray(jy), ctx)
    close(xr, jx, 1e-5)
    close(ldi, jldi, 1e-5)
    close(xr, x, 1e-5)
    assert tchain.layers[0].tag == "AffineCoupling"
    bad = x.copy()
    bad[3, 1] = np.nan
    message = "non-finite output in AffineCoupling.forward: tensor_bad=True"
    with pytest.raises(Exception, match=message):
        np.asarray(jax.jit(lambda v, b: jchain.forward(v, b, ctx)[0])(var, bad))
    with pytest.raises(FloatingPointError, match=message), torch.no_grad():
        tchain(torch.from_numpy(bad))


def test_checked_bijector_keeps_nf_tpus_variable_layout():
    from nf_tpu_torch.convert import export_jax_variables, variable_tree
    from nf_tpu_torch.train.checkpoint import structure_fingerprint

    jchain, var, tchain = _coupling_pair()
    back = export_jax_variables(tchain)
    assert jax.tree.structure(back) == jax.tree.structure(var)
    jax.tree.map(np.testing.assert_array_equal, back, var)
    # a checkpoint's layout: the wrapper's tree is its inner layer's
    assert (structure_fingerprint(variable_tree(tchain))
            == structure_fingerprint(variable_tree(type(tchain)([tchain.layers[0].inner]))))
    assert all(k.startswith("layers.0.inner.") for k in tchain.state_dict())


def test_enable_nan_debugging_turns_on_anomaly_detection():
    from nf_tpu_torch.utils.debug import enable_nan_debugging

    before = torch.is_anomaly_enabled()
    try:
        enable_nan_debugging()
        assert torch.is_anomaly_enabled()
    finally:
        torch.autograd.set_detect_anomaly(before)
