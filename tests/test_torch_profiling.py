"""The port's profiling tools (``nf_tpu_torch/utils/profiling.py``) on the
CPU, against nf_tpu's ``utils/profiling.py`` where both count.

* ``model_flops`` of a scanned model (``scan=True``: the couplings folded
  into ``ScannedChain`` blocks) equals the unrolled model's, forward and
  inverse;
* the flops of RealNVP 2-D and Glow 2-D (4 layers, F = 32, B = 256) are
  within 25 % of nf_tpu's ``model_flops`` (XLA's cost analysis; 9.74e6
  for RealNVP), the ratio printed;
* ``cost_analysis`` counts a matmul by its formula and element-wise work
  one flop an element, views nothing, bytes each op's inputs and output;
* ``trace`` writes a Chrome trace into its directory;
* ``roofline_estimate`` returns nf_tpu's keys, against the H100's peaks,
  and refuses a chip it has no peaks for;
* ``StepTimer`` keeps nf_tpu's window and mean.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(2)


def _port_model(name, layers=4, filters=32, **kw):
    from nf_tpu_torch.config import NetworkConfig
    from nf_tpu_torch.models import build_model

    model = build_model(name, (2,), "2d", NetworkConfig(name=name, layers=layers,
                                                        base_filters=filters, **kw),
                        device="cpu")
    model.init(torch.Generator().manual_seed(0))
    return model.eval()


@pytest.mark.parametrize("name", ["realnvp", "glow"])
def test_scanned_model_flops_equal_the_unrolled(name):
    from nf_tpu_torch.core.bijector import ScannedChain
    from nf_tpu_torch.utils.profiling import model_flops

    x = torch.randn(64, 2, generator=torch.Generator().manual_seed(1))
    unrolled = _port_model(name, layers=8, filters=16)
    scanned = _port_model(name, layers=8, filters=16, scan=True)
    assert any(isinstance(m, ScannedChain) for m in scanned.modules())
    for method in ("forward", "inverse"):
        a, b = model_flops(unrolled, x, method), model_flops(scanned, x, method)
        assert a["flops"] > 0 and a == b, (method, a, b)


@pytest.mark.parametrize("name", ["realnvp", "glow"])
def test_flops_near_nf_tpus_count(name):
    from nf_tpu.config import NetworkConfig as JNC
    from nf_tpu.core.bijector import Ctx
    from nf_tpu.models import build_model as jbuild
    from nf_tpu.utils.profiling import model_flops as jflops
    from nf_tpu_torch.utils.profiling import model_flops

    x = np.random.default_rng(0).standard_normal((256, 2)).astype(np.float32)
    jm = jbuild(name, (2,), datatype="2d", cfg=JNC(name=name, layers=4, base_filters=32))
    want = jflops(jm, jm.init(jax.random.PRNGKey(0)), x, Ctx(rng=None, train=False))["flops"]
    got = model_flops(_port_model(name), torch.from_numpy(x))["flops"]
    print(f"{name}: the port's flops {got:.4g}, nf_tpu's {want:.4g}, ratio {got / want:.4f}")
    if name == "realnvp":
        assert abs(want - 9.74e6) < 0.01e6
    assert 0.75 <= got / want <= 1.25


def test_cost_analysis_counts_ops():
    from nf_tpu_torch.utils.profiling import cost_analysis

    a, b = torch.randn(8, 16), torch.randn(16, 4)
    ca = cost_analysis(lambda p, q: torch.tanh(p @ q).t(), a, b)
    # mm 2*8*16*4, tanh one flop an output element; .t() a view
    assert ca["flops"] == 2 * 8 * 16 * 4 + 32
    assert ca["bytes accessed"] == 4 * ((8 * 16 + 16 * 4 + 32) + (32 + 32))


def test_trace_writes_a_file(tmp_path):
    from nf_tpu_torch.utils.profiling import trace

    with trace(str(tmp_path / "tb")) as prof:
        torch.tanh(torch.randn(64, 64) @ torch.randn(64, 64))
    assert prof.trace_path and os.path.dirname(prof.trace_path) == str(tmp_path / "tb")
    with open(prof.trace_path) as f:
        events = json.load(f)["traceEvents"]
    assert any("aten::mm" in str(e.get("name", "")) for e in events)


def test_roofline_estimate_keeps_nf_tpus_keys():
    from nf_tpu.utils.profiling import roofline_estimate as jroof
    from nf_tpu_torch.utils.profiling import roofline_estimate

    a, b = torch.randn(32, 32), torch.randn(32, 32)
    out = roofline_estimate(lambda p, q: p @ q, a, b, measured_seconds=1e-6)
    want = jroof(lambda p, q: p @ q, np.ones((32, 32), np.float32), np.ones((32, 32), np.float32),
                 measured_seconds=1e-6)
    assert set(out) == set(want)
    assert out["flops"] == 2 * 32 ** 3
    assert out["ridge_intensity"] == pytest.approx(67e12 / 3.35e12)
    assert out["pct_of_peak_flops"] == pytest.approx(100 * 2 * 32 ** 3 / 1e-6 / 67e12)
    assert set(roofline_estimate(lambda p: p + 1, a)) == set(jroof(lambda p: p + 1, np.ones(3)))
    with pytest.raises(ValueError, match="v5e"):
        roofline_estimate(lambda p: p + 1, a, chip="v5e")


def test_step_timer_window():
    from nf_tpu_torch.utils.profiling import StepTimer

    timer = StepTimer(window=3, device="cpu")
    timer.start()
    marks = [timer.mark() for _ in range(5)]
    assert len(timer._times) == 3 and timer.mean == pytest.approx(sum(marks[2:]) / 3)
