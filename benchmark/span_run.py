#!/usr/bin/env python3
"""Where a cell's host time goes: a traced run with the program's spans.

    python3 benchmark/span_run.py --workload <cell> --seed <n> --seconds <s>

One `harness.run_cell` of the cell as `run.py --trace 1` runs it, with the
port's spans (`nf_tpu_torch/utils/tracing.py`) recorded all through: its
first half is the host's phase (spans, no profiler yet: the `.spans`
metrics), its traced half the device's (spans under the profiler, each
device operation's CUPTI correlation id and the runtime's launch records
kept: `launch_lag_us.eval`, the clock check, the idle gaps put down to
program spans, the device time launched inside each span).  The recorded
run comes first in its process: once a profiler has run, CUPTI stays on the
launches of the process.

Prints the run's result line, then one JSON line each: `span_metrics` (the
readers of `metrics/*.spans.py` and `launch_lag_us.eval.py`), `span_check`
(the root spans against the harness's call-to-return over the host's
phase; the device clock's offsets by stretch of the window; the clock check
before and after they are taken out),
`idle_gaps` (each gap where it starts; `idle_gaps_median_shift` on the
harness's alignment alone), `idle_by_host_span` (each gap cut where the
host moved between spans) and `span_counts`; the same into
`build/spans/<cell>-<seed>.json`.  The device readings are taken on
the trace with its offsets taken out (`spans.device_offsets`,
`spans.realign`).  The benchmark's own runs never run this.
"""
import time

T0 = time.perf_counter_ns()

import argparse  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402

READERS = ("eval_self_us.spans", "launch_host_us.spans", "chain_self_us_per_image.spans",
           "conditioner_us_per_image.spans", "launch_lag_us.eval")


def span_profiler(base):
    """The harness's profiler class, keeping as well each device
    operation's correlation id and the runtime's launch records (their
    host start by correlation id), on the trace's perf clock."""

    class SpanProfiler(base):
        made = []

        def __enter__(self):
            SpanProfiler.made.append(self)
            return super().__enter__()

        def _read(self):
            from torch.autograd import DeviceType
            trace = super()._read()
            to_perf = self._perf0 - self._wall0 if trace.clock == "wall" else 0
            self.device_ops, self.runtime_launches = [], {}
            for e in self._prof.profiler.kineto_results.events():
                s = e.start_ns() + to_perf
                if e.device_type() == DeviceType.CUDA:
                    if not e.is_user_annotation():
                        self.device_ops.append((e.name(), s, s + e.duration_ns(),
                                                e.correlation_id()))
                elif "LaunchKernel" in e.name():
                    self.runtime_launches[e.correlation_id()] = s
            self.device_ops.sort(key=lambda o: o[1])
            self.syncs = list(trace.runtime_syncs)
            return trace

    return SpanProfiler


def traced_run(bench, cell, seed, seconds, device="cuda", t0=T0, **kw):
    """(result, Run, profiler) of one `run_cell(..., trace=1)` (`kw`: its
    `cfg` and `mix`) with the port's spans recorded over it, into
    `run.spans` and `run.dropped`; the profiler keeps its extra records
    (`span_profiler`)."""
    from benchmark import harness, tracing
    from nf_tpu_torch.utils.tracing import recording

    runs, make_run, profiler = [], harness.Run, tracing.Profiler

    def capture(*fields):
        runs.append(make_run(*fields))
        return runs[-1]

    harness.Run, tracing.Profiler = capture, span_profiler(profiler)
    try:
        with recording() as buf:
            result, _ = harness.run_cell(bench, cell, seed, seconds, 1, device, t0, **kw)
        made = tracing.Profiler.made
    finally:
        harness.Run, tracing.Profiler = make_run, profiler
    run = runs[0]
    run.spans, run.dropped = buf.spans, buf.dropped
    return result, run, made[-1]


def attach_trace(run, prof, kernel_names):
    """The profiler's extra records onto `run`, moved by the harness's clock
    shift: `device_ops`, `runtime_launches` and `port_kernels` (the port's
    kernels' records in device order)."""
    shift = run.trace.runtime_syncs[0] - prof.syncs[0] if prof.syncs else 0
    run.clock_shift_ns = shift
    run.device_ops = [(n, s + shift, e + shift, c) for n, s, e, c in prof.device_ops]
    run.runtime_launches = {c: t + shift for c, t in prof.runtime_launches.items()}
    port = re.compile(r"\b(" + "|".join(map(re.escape, kernel_names)) + r")\b")
    run.port_kernels = [op for op in run.device_ops if port.search(op[0])]


def span_check(run):
    """The root spans against the harness's call-to-return over the host's
    phase, and the share of a root outside its named children."""
    from benchmark import spans as sp

    idx, _ = sp.host_phase(run)
    own = sp.self_ns(run.spans)
    roots = [i for i in idx if run.spans[i][3] == -1 and run.spans[i][0] in sp.EVAL]
    root_ms = statistics.median((run.spans[i][2] - run.spans[i][1]) / 1e6 for i in roots)
    harness_ms = statistics.median((r.t_return - r.t_call) / 1e6 for r in run.untraced)
    return {"root_ms_median": root_ms, "harness_call_ms_median": harness_ms,
            "root_over_harness": root_ms / harness_ms,
            "root_self_share_median": statistics.median(
                own[i] / (run.spans[i][2] - run.spans[i][1]) for i in roots),
            "roots": len(roots), "requests": len(run.untraced),
            "spans": len(run.spans), "dropped": run.dropped}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    from run import ROOT, setup_environment
    setup_environment()

    import torch

    from benchmark import cells, spans, system

    if not torch.cuda.is_available():
        print("span runs are taken on a CUDA card; none is visible", file=sys.stderr)
        return 2
    bench = cells.Benchmark(ROOT)
    cell = bench.workload(args.workload)
    result, run, prof = traced_run(bench, cell, args.seed, args.seconds)
    print(json.dumps(result), flush=True)
    attach_trace(run, prof, system.kernel_names())
    before, gaps = spans.clock_check(run), spans.label_gaps(run)
    offsets = spans.device_offsets(run)
    spans.realign(run, offsets)
    out = {"span_metrics": {n: cells.reader(n)(run) for n in READERS},
           "span_check": {**span_check(run), "clock_shift_us": run.clock_shift_ns / 1e3,
                          "device_offset_us": {
                              "least": min(offsets.values(), default=0) / 1e3,
                              "most": max(offsets.values(), default=0) / 1e3,
                              "stretches_past_10us": sum(abs(o) > 10_000
                                                         for o in offsets.values()),
                              "stretches": len(offsets)},
                          "runtime_launch_records": len(run.runtime_launches),
                          "port_kernel_records": len(run.port_kernels),
                          "clock_check_median_shift": before,
                          "clock_check_offsets_out": spans.clock_check(run)},
           "idle_gaps_median_shift": gaps,
           "idle_gaps": spans.label_gaps(run),
           "idle_by_host_span": spans.label_gaps(run, cut=True),
           "span_counts": spans.span_counts(run)}
    for key, value in out.items():
        print(json.dumps({key: value}), flush=True)
    folder = ROOT / "build" / "spans"
    folder.mkdir(parents=True, exist_ok=True)
    with open(folder / f"{args.workload}-{args.seed}.json", "w") as f:
        json.dump({"workload": args.workload, "seed": args.seed,
                   "seconds": args.seconds, "device": torch.cuda.get_device_name(0),
                   "result": result, **out,
                   "device_offsets_us": {b: o / 1e3 for b, o in sorted(offsets.items())}},
                  f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
