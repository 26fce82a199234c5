"""The served program's own spans against the benchmark's requests and the
device trace.

The port records spans at its layer boundaries while a recording is on
(``nf_tpu_torch/utils/tracing.py``): ``(name, start_ns, end_ns, parent,
request)`` on the host's perf clock, the clock of the harness's records and
of the shifted device trace.  A run that carries them has ``run.spans``;
its requests before the profiler started (``run.untraced``) are the host's
phase, read with no CUPTI cost on the launches, and its traced window
(``run.requests``, ``run.trace``) the device's.  Every function here is
plain arithmetic on those lists: no module of the port is imported.

The device trace's clock is checked against the launch spans: a port
kernel cannot start before its wrapper was called, nor before the
runtime's record of its launch (``clock_check``).  Each port kernel record
is matched to the launch span in which CUPTI's runtime record of the same
correlation id fell (``matched``).  The harness's clock shift is one
median offset for the whole window; where the device's timestamps stray
from the host's within it, ``realign`` moves them back, stretch by
stretch (``device_offsets``).
"""
from __future__ import annotations

import bisect
import statistics
from collections import defaultdict

from benchmark.tracing import DeviceTrace

SLACK_NS = 2000     # a kernel that starts this far before its launch span is a clock error
STRETCH_NS = 100_000_000   # the stretches over which the device's clock offset is read
TOP_GAPS = 16       # idle-gap labels kept
EVAL = ("EvalProgram.log_prob", "EvalProgram.sample", "EvalProgram.input",
        "EvalProgram.draw", "EvalProgram.logp")
CHAIN = ("coupling.split", "coupling.merge")


def self_ns(spans) -> list:
    """Each span's duration less what its child spans cover."""
    out = [e - s for _, s, e, _, _ in spans]
    for _, s, e, parent, _ in spans:
        if parent >= 0:
            out[parent] -= e - s
    return out


def between(spans, t0: int, t1: int) -> range:
    """Indices of the spans that start inside [t0, t1]."""
    starts = [s[1] for s in spans]
    return range(bisect.bisect_left(starts, t0), bisect.bisect_right(starts, t1))


def host_phase(run):
    """(indices of the spans, images or rows served) of the host's phase:
    the requests before the profiler, recorded with no profiler on; None
    where the run carries no spans there."""
    spans = getattr(run, "spans", None)
    if not spans or not run.untraced:
        return None
    idx = between(spans, run.untraced[0].t_call, run.untraced[-1].t_end)
    if not idx:
        return None
    return idx, sum(r.rows for r in run.untraced)


class Starts:
    """The innermost span open at a time, over spans of one thread (they
    nest, in the order they opened)."""

    def __init__(self, spans):
        self.spans, self.starts = spans, [s[1] for s in spans]

    def innermost(self, t: int) -> int:
        """Index of the innermost span open at t, or -1."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and self.spans[i][2] < t:
            i = self.spans[i][3]
        return i


def matched(run):
    """[(launch span index, port kernel record)] of the traced window, the
    records (name, start_ns, end_ns, correlation id) in device order: each
    with the launch span in which the runtime's launch record of its
    correlation id fell, where CUPTI gave those records; else the n-th
    launch span of the window with the n-th record (one stream, one kernel
    a launch), None where their counts differ (a record the profiler
    dropped).  None where nothing is there."""
    spans = getattr(run, "spans", None)
    kernels = getattr(run, "port_kernels", None)
    if not spans or not kernels:
        return None
    runtime = getattr(run, "runtime_launches", None)
    if runtime:
        index = Starts(spans)
        pairs = []
        for k in kernels:
            i = index.innermost(runtime[k[3]]) if k[3] in runtime else -1
            if i >= 0 and spans[i][0].startswith("launch."):
                pairs.append((i, k))
        return pairs or None
    idx = [i for i in between(spans, *run.window_ns) if spans[i][0].startswith("launch.")]
    return list(zip(idx, kernels)) if idx and len(idx) == len(kernels) else None


def clock_check(run) -> dict:
    """How the device trace's clock sits against the launch spans:
    ``launches_before_span`` (port kernels that start more than SLACK_NS
    before their launch span), ``launch_events_in_span`` (the share of the
    port kernels' runtime launch records that fell inside a launch span;
    None where CUPTI gave none), the least time from such a record to its
    kernel's start (µs: below 0 the trace's device clock runs ahead of its
    host clock), and the lag of each kernel behind its span's start
    (median, µs)."""
    pairs = matched(run)
    if pairs is None:
        return {"matched": 0}
    spans = run.spans
    runtime = getattr(run, "runtime_launches", None) or {}
    seen = sum(k[3] in runtime for k in run.port_kernels)
    to_kernel = [k[1] - runtime[k[3]] for _, k in pairs if k[3] in runtime]
    return {"matched": len(pairs),
            "launches_before_span": sum(k[1] < spans[i][1] - SLACK_NS for i, k in pairs),
            "launch_events_in_span": 100.0 * len(to_kernel) / seen if seen else None,
            "launch_event_to_kernel_us_min": min(to_kernel) / 1e3 if to_kernel else None,
            "lag_us_median": statistics.median(k[1] - spans[i][1] for i, k in pairs) / 1e3}


def device_offsets(run) -> dict:
    """{stretch: ns}: how far the device's timestamps run behind (above 0)
    or ahead of (below 0) the host's in each STRETCH_NS stretch of the traced
    window: the least delay from a runtime launch record to the start of
    the operation it launched, less the median of those least delays (the
    launch's own latency, where the device was idle at a launch, as it is
    at each request's first)."""
    runtime = getattr(run, "runtime_launches", None) or {}
    t0, t1 = run.window_ns
    least = {}
    for _, start, _, corr in getattr(run, "device_ops", None) or ():
        t = runtime.get(corr)
        if t is not None and t0 <= t < t1:
            b = (t - t0) // STRETCH_NS
            least[b] = min(least.get(b, start - t), start - t)
    if not least:
        return {}
    base = statistics.median(least.values())
    return {b: v - base for b, v in least.items()}


def realign(run, offsets: dict) -> None:
    """Move the run's device operations (its trace, `device_ops`,
    `port_kernels`) back by the offset of the stretch in which each one's
    launch record (else its start) fell; a stretch with no offset takes
    the nearest one's."""
    if not offsets:
        return
    t0, keys = run.window_ns[0], sorted(offsets)
    runtime = getattr(run, "runtime_launches", None) or {}

    def offset(t):
        b = (t - t0) // STRETCH_NS
        i = bisect.bisect_left(keys, b)
        near = [keys[j] for j in (i - 1, i) if 0 <= j < len(keys)]
        return offsets[min(near, key=lambda k: abs(k - b))]

    ops = []
    for n, s, e, c in run.device_ops:
        o = offset(runtime.get(c, s))
        ops.append((n, s - o, e - o, c))
    ops.sort(key=lambda op: op[1])
    port = {k[3] for k in run.port_kernels}
    run.device_ops, run.port_kernels = ops, [op for op in ops if op[3] in port]
    run.trace = DeviceTrace([op[:3] for op in ops], run.trace.clock, run.trace.runtime_syncs)


def device_by_span(run) -> dict:
    """{span name: device ns of the operations launched inside it}: each
    device operation whose runtime launch record (by correlation id) fell
    inside a span counts for that span and every span around it."""
    spans = getattr(run, "spans", None)
    ops = getattr(run, "device_ops", None)
    runtime = getattr(run, "runtime_launches", None) or {}
    if not spans or not ops or not runtime:
        return {}
    index = Starts(spans)
    by = defaultdict(int)
    for _, start, end, corr in ops:
        t = runtime.get(corr)
        if t is None:
            continue
        i = index.innermost(t)
        names = set()
        while i >= 0:
            names.add(index.spans[i][0])
            i = index.spans[i][3]
        for n in names:
            by[n] += end - start
    return dict(by)


def span_counts(run) -> dict:
    """{span name: {per_request, self_us_median, self_s, device_s}}: its
    spans a request and their self times over the host's phase, and the
    device time of the operations launched inside it over the traced
    window."""
    phase = host_phase(run)
    if phase is None:
        return {}
    idx, _ = phase
    spans = run.spans
    own = self_ns(spans)
    names = defaultdict(list)
    for i in idx:
        names[spans[i][0]].append(own[i])
    device = device_by_span(run)
    requests = len(run.untraced)
    return {n: {"per_request": len(t) / requests,
                "self_us_median": statistics.median(t) / 1e3,
                "self_s": sum(t) / 1e9,
                "device_s": device.get(n, 0) / 1e9}
            for n, t in sorted(names.items(), key=lambda kv: -sum(kv[1]))}


def label_gaps(run, cut: bool = False):
    """[[label, idle seconds]] of the traced window's idle gaps, the
    TOP_GAPS labels that idled longest: ``<harness span>/<innermost program span>``,
    or the harness's label alone where no program span was open, at each
    gap's start; with ``cut`` each gap is cut where the host moved from one
    span to another, and each piece labelled by where the host was during
    it."""
    if run.trace is None:
        return []
    spans = getattr(run, "spans", None) or []
    t0, t1 = run.window_ns
    marks = []
    for r in run.requests:
        marks += [(r.t_call, f"{r.kind}.call"), (r.t_return, f"{r.kind}.sync"),
                  (r.t_end, "between")]
    starts = [t for t, _ in marks]
    cuts = sorted(set(starts + [s[1] for s in spans] + [s[2] for s in spans])) if cut else []
    index = Starts(spans)
    by = defaultdict(int)
    for a, b in run.trace.gaps(t0, t1):
        points = [a] + cuts[bisect.bisect_right(cuts, a):bisect.bisect_left(cuts, b)] + [b]
        for p, q in zip(points, points[1:]):
            at = p if not cut else (p + q) // 2     # a piece lies inside one state
            j = bisect.bisect_right(starts, at) - 1
            label = marks[j][1] if j >= 0 else "before"
            i = index.innermost(at)
            by[f"{label}/{spans[i][0]}" if i >= 0 else label] += q - p
    top = sorted(by.items(), key=lambda kv: -kv[1])[:TOP_GAPS]
    return [[n, ns / 1e9] for n, ns in top]
