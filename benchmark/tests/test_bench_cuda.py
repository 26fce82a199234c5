"""On the card: one short run of each cell, correct, with its metrics.
`python -m pytest benchmark/tests -m cuda` on a machine with an H100."""
import json
import subprocess
import sys

import pytest

from benchmark.cells import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("name,trace", [("realnvp-2d.bulk", 0), ("realnvp-img32x1.bulk", 1)])
def test_a_short_run_on_the_card(name, trace):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name, "--seed",
                          str(2**31 + 77), "--seconds", "3", "--trace", str(trace)],
                         cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
