"""The output check drives a whole run (the look for a card skipped, on
the CPU at a small depth) and comes out false for each fault the cells can
have, and for the control; the sound program passes."""
import pytest

from benchmark import faults, generator
from benchmark.tests.tiny import run_tiny, tiny

CELLS = ["realnvp-2d.bulk", "realnvp-img32x1.bulk"]


@pytest.mark.parametrize("name", CELLS)
def test_sound_program_is_correct(name):
    result, table = run_tiny(name)
    assert result["correct"] and result["failed"] == 0
    assert set(table) == {"logp_gap", "sample_logp_gap", "sample_x_gap"}
    assert all(v["value"] < v["limit"] for v in table.values())


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_each_fault_fails_the_check(name, fault):
    result, table = run_tiny(name, wrap=faults.FAULTS[fault])
    assert not result["correct"]
    assert any(v["value"] > v["limit"] for v in table.values())


@pytest.mark.parametrize("name", CELLS)
def test_the_tf32_control_fails_the_check(name):
    result, table = run_tiny(name, controls=("tf32_emulated",))
    control = result["control"]["tf32_emulated"]
    assert any(control[k] > v["limit"] for k, v in table.items())
    assert all(control[k] > 3 * v["value"] for k, v in table.items())


def test_a_failing_request_is_counted_and_not_correct():
    warm = sum(kind == "log_prob" for kind, _ in generator.entries(tiny("realnvp-2d.bulk")[3]))

    class Raising(faults._Wrapped):
        calls = 0

        def log_prob(self, x):
            self.calls += 1
            if self.calls > warm:      # set-up's warm requests pass
                raise RuntimeError("planted")
            return self.program.log_prob(x)

        def sample(self, n, generator):
            return self.program.sample(n, generator)

    result, _ = run_tiny("realnvp-2d.bulk", wrap=Raising)
    assert result["failed"] > 0 and not result["correct"]
