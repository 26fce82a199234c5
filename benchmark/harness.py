"""One run of one cell: set-up, the window, the output check, the metrics.

`run_cell` is what `run.py` runs; the output check's control and fault
readings (`control.py`, `tests/`) run it too, with the control's answers or
a broken program in the served program's place.
"""
from __future__ import annotations

import gc
import json
import sys
import time
import traceback
from dataclasses import dataclass

FORBIDDEN = {"jax", "jaxlib", "flax", "nf_tpu"}


@dataclass
class Record:
    kind: str
    rows: int
    t_call: int      # perf_counter_ns at the call
    t_return: int    # ... when it returned
    t_end: int       # ... when its synchronize returned


@dataclass
class Run:
    """What the metric readers read: the cell, its configuration and mix,
    the work counts, the window's requests (a traced run's: those of its
    traced second half, the window's), and the traced run's trace."""
    cell: dict
    cfg: dict
    mix: dict
    work: object
    requests: list
    window_ns: tuple
    setup_s: float
    trace: object
    launched: dict
    untraced: list   # a traced run's requests before the profiler started


def forbidden_modules():
    """Modules of JAX or of nf_tpu loaded into this process, by whole
    top-level name."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def run_cell(bench, cell, seed, seconds, trace, device, t0, wrap=None, cfg=None, mix=None,
             controls=()):
    """(result, numbers compared) of one run.  `wrap(program)` replaces the
    served program (the output check's fault tests); `cfg` and `mix`
    replace the cell's files; each of `controls` ('tf32', 'tf32_emulated')
    also reads the control on the same requests, into result["control"]."""
    import torch

    from benchmark import cells, checks, generator, state, system, tracing

    phases = {}

    def phase(name):
        phases[name] = (time.perf_counter_ns() - t0) / 1e9

    phase("imported")
    cfg = cfg or bench.config(cell)
    mix = mix or bench.traffic(cell)
    reference = cells.family("reference", cfg["network"])
    work = cells.family("work", cfg["network"])
    limits = bench.limits(cell)
    torch.set_num_threads(2)

    params = state.draw(reference.param_specs(cfg), seed, device)
    phase("state drawn")
    model, program = system.served_program(cfg, params, device)
    if wrap is not None:
        program = wrap(program)
    phase("program built")
    traffic = generator.Traffic(mix, cfg["dims"], seed, device)
    gen = torch.Generator(device=device)

    def args(req):
        """The request's arguments, made before its call."""
        if req.kind == "sample":
            gen.manual_seed(req.seed)
            return {"rows": req.rows, "generator": gen}
        return {"x": traffic.input(req)}

    for i, (kind, rows) in enumerate(generator.entries(mix)):   # every shape served
        warm = generator.Request(-1, kind, rows, 0, seed + i, False)
        system.serve(program, kind, **args(warm))
    system.synchronize(device)
    phase("warmed")
    setup_s = (time.perf_counter_ns() - t0) / 1e9

    requests = traffic.cycles()
    records, kept, kept_kinds, failed = [], [], set(), 0

    def serve_until(deadline):
        """Serve the mix's requests until one ends past `deadline`; returns
        their records."""
        nonlocal failed, out, kw
        done = []
        while True:
            req = next(requests)
            kw = args(req)
            t_call = time.perf_counter_ns()
            try:
                out = system.serve(program, req.kind, **kw)
                t_return = time.perf_counter_ns()
                system.synchronize(device)
            except Exception:  # a failed request is counted, and the loop goes on
                failed += 1
                out, t_return = None, time.perf_counter_ns()
                if failed == 1:
                    traceback.print_exc()
            t_end = time.perf_counter_ns()
            done.append(Record(req.kind, req.rows, t_call, t_return, t_end))
            if req.checked or req.kind not in kept_kinds:
                kept.append((req, out))
                kept_kinds.add(req.kind)
            if t_end >= deadline:
                return done

    out = kw = None
    gc.collect()    # set-up's garbage; the collector stays on, as in any caller
    start = time.perf_counter_ns()
    untraced = []
    if trace:
        # the first half untraced, no profiler loaded: the host's own times.
        # The profiler's first start loads CUPTI, which takes seconds; the
        # traced half starts once one device operation has been traced.
        untraced = serve_until(start + int(seconds * 0.5e9))
        before = system.launch_counts()
        prof = tracing.Profiler()
        t_start = time.perf_counter_ns()
        with prof:
            torch.ones(1, device=device).add_(1)
            system.synchronize(device)
            traced_from = time.perf_counter_ns()
            prof.start_s = (traced_from - t_start) / 1e9
            records = serve_until(traced_from + int(seconds * 0.5e9))
    else:
        before = system.launch_counts()
        records = serve_until(start + int(seconds * 1e9))
    after = system.launch_counts()
    launched = {k: after[k] - before.get(k, 0) for k in after if after[k] != before.get(k, 0)}

    cuda = torch.device(device).type == "cuda"
    memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del model, program, out, kw
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_ref = time.perf_counter_ns()
    block = int(mix["check"]["block_rows"])
    read = checks.readings(kept, reference, cfg, params, traffic, block)
    ok, table = checks.verdict(read, limits)
    result_controls = {
        mode: checks.readings(kept, reference, cfg, params, traffic, block,
                              checks.control_answer(reference, cfg, params, traffic, block,
                                                    emulate=mode == "tf32_emulated"))
        for mode in controls}
    host_ms = sorted((r.t_return - r.t_call) / 1e6 for r in untraced + records)
    print(f"window: {len(host_ms)} requests, the host's median {host_ms[len(host_ms) // 2]} ms "
          f"from a call to its return", file=sys.stderr)
    print(f"setup phases (s from start): {json.dumps(phases)}; the check of "
          f"{len(kept)} requests took {(time.perf_counter_ns() - t_ref) / 1e9:.2f} s",
          file=sys.stderr)

    window = (records[0].t_call, records[-1].t_end)
    trace_data = None
    if trace:
        trace_data = prof.trace
        shift = tracing.clock_shift(trace_data, [r.t_end for r in records])
    run = Run(cell, cfg, mix, work, records, window, setup_s, trace_data, launched,
              untraced)
    metrics = {}
    for m in bench.metrics(cell, bool(trace)):
        value = cells.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": ok and failed == 0, "attempted": len(untraced) + len(records),
              "failed": failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                         "count": int(cell["chips"]), "memory_peak_bytes": int(memory_peak)}}
    if trace:
        t0w, t1w = window
        result["device"]["busy_s"] = trace_data.busy_ns(t0w, t1w) / 1e9
        result["device"]["window_s"] = (t1w - t0w) / 1e9
        spans = []
        for r in records:
            spans += [(r.t_call, f"{r.kind}.call"), (r.t_return, f"{r.kind}.sync"),
                      (r.t_end, "between")]
        result["breakdown"] = {
            "device_ops": trace_data.top_ops(10),
            "idle_gaps": tracing.label_gaps(trace_data.gaps(t0w, t1w), spans, 10)}
        seen = {}
        for n in system.kernel_names():
            d = sorted(trace_data.durations(n))
            if d:
                seen[n] = {"records": len(d), "us_min": d[0] / 1e3,
                           "us_median": d[len(d) // 2] / 1e3, "us_max": d[-1] / 1e3}
        print(json.dumps({"trace_counts": {
            "profiler_kernels": seen, "launch_counters": launched,
            "clock": trace_data.clock, "clock_shift_us": shift / 1e3,
            "host_synchronizations_seen": len(trace_data.runtime_syncs),
            "profiler_start_s": prof.start_s, "profiler_stop_s": prof.stop_s,
            "trace_read_s": prof.read_s, "untraced_requests": len(untraced),
            "requests": len(records), "device_ops": len(trace_data.ops)}}))
    if controls:
        result["control"] = result_controls
    result["checks"] = table
    return result, table
