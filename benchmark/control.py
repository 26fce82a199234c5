#!/usr/bin/env python3
"""Readings that the output check's limits are set from, on the card.

    python3 benchmark/control.py --workload <cell> --seconds <s>
        --seeds <n,...> [--control-seeds <n,...>] [--faults identity,half,altered]
        [--fault-seeds <n,...>]

Each of `--seeds` is one run of the cell at its own size (`harness.run_cell`,
a window of `--seconds`): the program's readings, beside the limits.  Each of
`--control-seeds` reads as well the control on the same requests: the
reference put in the program's place in TF32, with cuBLAS and cuDNN allowed
TF32 (`tf32`) and with its operands rounded to TF32 by itself
(`tf32_emulated`).  Each fault of `faults.py` is planted under the program
and read on each of `--fault-seeds`.  One JSON line a run on standard
output, then the summary: the largest sound reading of each number, the
smallest control reading, and each fault's smallest.  The benchmark's own
runs never run this.
"""
import time

T0 = time.perf_counter_ns()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

from run import ROOT, setup_environment  # noqa: E402


def _seeds(text):
    return [int(s) for s in text.split(",") if s]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=_seeds, default=[])
    p.add_argument("--control-seeds", type=_seeds, default=[])
    p.add_argument("--faults", default="")
    p.add_argument("--fault-seeds", type=_seeds, default=[])
    args = p.parse_args(argv)
    setup_environment()

    import torch

    from benchmark import cells, faults, harness

    if not torch.cuda.is_available():
        print("control readings are taken on a CUDA card; none is visible", file=sys.stderr)
        return 2
    bench = cells.Benchmark(ROOT)
    cell = bench.workload(args.workload)
    sound, control, faulty = {}, {}, {}
    runs = [(s, None, ("tf32", "tf32_emulated") if s in args.control_seeds else ())
            for s in dict.fromkeys(args.seeds + args.control_seeds)]
    runs += [(s, f, ()) for f in filter(None, args.faults.split(",")) for s in args.fault_seeds]
    for seed, fault, controls in runs:
        wrap = faults.FAULTS[fault] if fault else None
        t0 = time.perf_counter_ns()
        result, table = harness.run_cell(bench, cell, seed, args.seconds, 0, "cuda", t0,
                                         wrap=wrap, controls=controls)
        line = {"seed": seed, "fault": fault, "correct": result["correct"],
                "attempted": result["attempted"],
                "readings": {k: v["value"] for k, v in table.items()},
                "control": result.get("control", {}),
                "eval_samples_per_s": result["metrics"].get("eval_samples_per_s", {}).get("value"),
                "seconds": (time.perf_counter_ns() - t0) / 1e9}
        print(json.dumps(line), flush=True)
        for k, v in line["readings"].items():
            if fault:
                faulty.setdefault(fault, {}).setdefault(k, []).append(v)
            else:
                sound.setdefault(k, []).append(v)
        for mode, read in line["control"].items():
            for k, v in read.items():
                control.setdefault(mode, {}).setdefault(k, []).append(v)
    print(json.dumps({"summary": {
        "workload": args.workload, "limits": bench.limits(cell),
        "sound_largest": {k: max(v) for k, v in sound.items()},
        "sound_runs": {k: len(v) for k, v in sound.items()},
        "control_smallest": {m: {k: min(v) for k, v in r.items()} for m, r in control.items()},
        "fault_smallest": {f: {k: min(v) for k, v in r.items()} for f, r in faulty.items()},
        "device": torch.cuda.get_device_name(0)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
