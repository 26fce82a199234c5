"""The plain reference against the served program's CPU path (the port's
plain versions), at a small size."""
import pytest
import torch

from benchmark import state, system
from benchmark.reference import realnvp as ref


def _cfg(datatype, layers, filters):
    dims = [2] if datatype == "2d" else [32, 32, 1]
    return {"network": "realnvp", "dims": dims, "datatype": datatype,
            "network_config": {"layers": layers, "base_filters": filters}}


@pytest.mark.parametrize("datatype,layers,filters,rows", [
    ("2d", 4, 8, 512), ("2d", 32, 32, 256), ("image", 2, 8, 4)])
def test_reference_matches_the_program_on_the_cpu(datatype, layers, filters, rows):
    torch.set_num_threads(2)
    cfg = _cfg(datatype, layers, filters)
    params = state.draw(ref.param_specs(cfg), 2**31 + 99, "cpu")
    model, program = system.served_program(cfg, params, "cpu")
    g = torch.Generator().manual_seed(5)
    x = torch.rand((rows,) + tuple(cfg["dims"]), generator=g)
    want = ref.log_prob(params, cfg, x)
    got = program.log_prob(x)
    assert float((got - want).abs().max()) <= 2e-6 * float(want.abs().max())
    y, lp = program.sample(rows, torch.Generator().manual_seed(17))
    z = torch.randn((rows,) + tuple(cfg["dims"]), generator=torch.Generator().manual_seed(17))
    y_ref, lp_ref = ref.sample(params, cfg, z)
    assert float((y - y_ref).abs().max()) <= 2e-6 * float(y_ref.abs().max())
    assert float((lp - lp_ref).abs().max()) <= 2e-6 * float(lp_ref.abs().max())


@pytest.mark.parametrize("datatype", ["2d", "image"])
def test_state_keys_are_the_programs(datatype):
    cfg = _cfg(datatype, 32, 32)
    params = state.draw(ref.param_specs(cfg), 0, "cpu")
    model, _ = system.served_program(cfg, params, "cpu")
    assert set(params) == set(model.state_dict())
    if datatype == "image":
        assert sum(p.numel() for p in model.parameters()) == 6_818_978


def test_state_is_drawn_from_the_seed_off_identity():
    cfg = _cfg("2d", 4, 8)
    specs = ref.param_specs(cfg)
    a, b = state.draw(specs, 5, "cpu"), state.draw(specs, 5, "cpu")
    c = state.draw(specs, 6, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["bijector.layers.1.net.layers.0.v"],
                           c["bijector.layers.1.net.layers.0.v"])
    for key, shape, lo, hi in specs:
        assert tuple(a[key].shape) == tuple(shape)
        assert float(a[key].min()) >= lo - 1e-6 and float(a[key].max()) <= hi + 1e-6
    assert float(a["bijector.layers.0.running_var"].sub(1).abs().max()) > 0.0


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10 + 2**-12, -3.14159265])
    r = ref._tf32(x)
    assert r[0] == 1.0 and r[1] == 1.0            # a tie rounds to even
    assert r[2] == 1.0 + 2**-10
    assert abs(float(r[3]) + 3.14159265) < 2**-9
    assert torch.equal(ref._tf32(r), r)
