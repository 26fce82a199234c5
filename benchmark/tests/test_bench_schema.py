"""The result line, and the exits without a card."""
import json
import subprocess
import sys

import pytest

from benchmark.cells import ROOT
from benchmark.tests.tiny import run_tiny


@pytest.mark.parametrize("name", ["realnvp-2d.bulk", "realnvp-img32x1.bulk"])
def test_result_line(name):
    result, table = run_tiny(name)
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert isinstance(result["correct"], bool) and result["attempted"] > 0
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert "setup_s" in result["metrics"] and "eval_samples_per_s" in result["metrics"]
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for v in result["checks"].values():
        assert set(v) == {"value", "limit"}
    json.dumps(result)


def test_p95_only_where_listed():
    result, _ = run_tiny("realnvp-img32x1.bulk")
    assert "eval_request_p95_ms" not in result["metrics"]
    result, _ = run_tiny("realnvp-2d.bulk")
    assert "eval_request_p95_ms" in result["metrics"]


def test_no_card_no_result():
    """Without a CUDA card the run exits non-zero and prints nothing on
    standard output (this test decides inside itself whether there is one)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "realnvp-2d.bulk",
                          "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
