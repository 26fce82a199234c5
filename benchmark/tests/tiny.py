"""Cells cut to sizes a CPU test can hold: the configuration's depth and the
traffic's rows, never a width the output check depends on."""
from __future__ import annotations

import time

from benchmark import cells, harness

# each entry's rows divided by `shrink`; the pool and the check's blocks to match
CUTS = {"realnvp-2d.bulk": {"layers": 4, "shrink": 64, "pool": 2048, "block_rows": 4096},
        "realnvp-img32x1.bulk": {"layers": 2, "shrink": 32, "pool": 40, "block_rows": 4}}


def tiny(name: str):
    """(bench, cell, cfg, mix) of the cell cut for the CPU."""
    bench = cells.Benchmark()
    cell = bench.workload(name)
    cut = CUTS[name]
    cfg, mix = bench.config(cell), bench.traffic(cell)
    cfg["network_config"]["layers"] = cut["layers"]
    for entry in mix["requests"]:
        entry["rows"] = max(1, entry["rows"] // cut["shrink"])
    mix["data"]["pool"] = cut["pool"]
    mix["check"]["block_rows"] = cut["block_rows"]
    return bench, cell, cfg, mix


def run_tiny(name: str, seed: int = 7, seconds: float = 0.3, trace: int = 0, **kw):
    bench, cell, cfg, mix = tiny(name)
    return harness.run_cell(bench, cell, seed, seconds, trace, "cpu", time.perf_counter_ns(),
                            cfg=cfg, mix=mix, **kw)
