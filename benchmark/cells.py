"""`BENCHMARK.json` and the files it names, found by name."""
from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Benchmark:
    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.spec = _json(self.root / "BENCHMARK.json")

    def workload(self, name: str) -> dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, cell: dict) -> dict:
        for c in self.spec["configs"]:
            if c["name"] == cell["config"]:
                return _json(self.root / c["file"])
        raise KeyError(f"no configuration {cell['config']!r} in BENCHMARK.json")

    def traffic(self, cell: dict) -> dict:
        return _json(HERE / "traffic" / f"{cell['traffic']}.json")

    def limits(self, cell: dict) -> dict:
        return _json(HERE / "limits" / f"{cell['config']}.json")["limits"]

    def metrics(self, cell: dict, trace: bool) -> list:
        """The cell's metric entries: its end-to-end ones, or with `trace`
        its per-layer ones."""
        entries = self.spec["per_layer" if trace else "end_to_end"]
        return [m for m in entries if cell["name"] in m.get("workloads", [cell["name"]])]


def family(kind: str, network: str):
    """`reference/<network>.py` or `work/<network>.py` as a module."""
    return importlib.import_module(f"benchmark.{kind}.{network}")


def reader(name: str):
    """The `read(run)` function of `metrics/<name>.py`."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
