"""BENCHMARK.json against the limits its format sets, and every configuration,
mix, limit, reference, work count and metric it names found by name."""
import json
import math
import re

import pytest

from benchmark import cells

BENCH = cells.Benchmark()
SPEC = BENCH.spec
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_names():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"] and SPEC["paths"] == ["benchmark"]
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200


def test_run_seconds_fit_the_check_with_24_cells():
    r = SPEC["run_seconds"]
    assert isinstance(r, int) and 1 <= r <= 51
    assert (2 + 14 * 24) * (r + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", SPEC["workloads"], ids=lambda w: w["name"])
def test_every_cell_resolves(cell):
    cfg = BENCH.config(cell)
    mix = BENCH.traffic(cell)
    limits = BENCH.limits(cell)
    assert cfg["name"] == cell["config"] and "requests" in mix
    assert set(limits) == {"logp_gap", "sample_logp_gap", "sample_x_gap"}
    assert all(0 < v < 1 for v in limits.values())
    ref = cells.family("reference", cfg["network"])
    work = cells.family("work", cfg["network"])
    assert callable(ref.log_prob) and callable(work.model_flops)
    e2e = BENCH.metrics(cell, False)
    per = BENCH.metrics(cell, True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and per


@pytest.mark.parametrize("metric", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_every_metric_has_its_reader(metric):
    assert callable(cells.reader(metric["name"]))


@pytest.mark.parametrize("config", SPEC["configs"], ids=lambda c: c["name"])
def test_config_entries_match_their_files(config):
    with open(cells.ROOT / config["file"]) as f:
        cfg = json.load(f)
    assert config["file"].startswith("benchmark/")
    assert cfg["name"] == config["name"] and cfg["source"] == config["source"]
    assert cfg["reduced"] == config["reduced"] == []
    assert math.prod(cfg["dims"]) > 0
