#!/usr/bin/env python3
"""Run one cell of the benchmark once.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the served program of the cell's configuration with the state
drawn from the seed, makes the traffic's inputs, and serves one warm request
of each (kind, rows) entry of the mix.  The window then serves the mix's
requests, one client in a closed loop, each request ending in a
synchronize, until `--seconds` have passed.  With `--trace 1` the first
half of that time runs with no profiler loaded (the host's own times per
request); then a profiler starts and records the device over as long
again, the traced window.  Once the window has closed and
the served program is freed, the plain reference recomputes the requests
the generator marked, and the run is correct when every number compared is
within its limit.

The last line of standard output is the result (JSON: correct, attempted,
failed, metrics, device, with `--trace 1` breakdown, and last the numbers
compared, each beside its limit); the last lines of standard error repeat
those numbers.  The run exits non-zero without a result where no CUDA card
(or fewer than the cell asks for) is visible, or where JAX or nf_tpu was
loaded into the process.
"""
import time

T0 = time.perf_counter_ns()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# build and kernel caches at fixed paths inside the checkout
CACHES = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
          "TORCHINDUCTOR_CACHE_DIR": "inductor", "CUDA_CACHE_PATH": "cuda"}


def setup_environment():
    """Caches at fixed paths inside the checkout, and the checkout's root,
    not this folder, on the import path."""
    for var, sub in CACHES.items():
        os.environ[var] = str(ROOT / "build" / "benchmark" / sub)
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [str(ROOT)] + [s for s in sys.path if os.path.abspath(s or ".") != here]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    setup_environment()

    import torch

    from benchmark import cells, harness

    bench = cells.Benchmark(ROOT)
    cell = bench.workload(args.workload)
    t_torch = (time.perf_counter_ns() - T0) / 1e9
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"{args.workload} needs {cell['chips']} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    torch.cuda.init()
    print(f"start: torch imported at {t_torch:.2f} s, the card ready at "
          f"{(time.perf_counter_ns() - T0) / 1e9:.2f} s", file=sys.stderr)
    result, table = harness.run_cell(bench, cell, args.seed, args.seconds, args.trace, "cuda", T0)
    leaked = harness.forbidden_modules()
    if leaked:
        print(f"JAX or nf_tpu was loaded into the run: {', '.join(leaked)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    print(f"correct {result['correct']}, {result['failed']} requests failed", file=sys.stderr)
    for name, v in table.items():
        print(f"check {name} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
