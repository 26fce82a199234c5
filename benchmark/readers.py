"""What the metric readers share: the window and a kernel's roofline."""
from __future__ import annotations

from collections import Counter

from .work import kernels


def window_s(run) -> float:
    t0, t1 = run.window_ns
    return (t1 - t0) / 1e9


def sizes(run) -> Counter:
    """{(kind, rows): requests} of the window."""
    return Counter((r.kind, r.rows) for r in run.requests)


def roofline(run, group: str, kernel_names, counters, mac_flops_per_s: float,
             flops_per_s: float, bytes_per_s: float):
    """Percent of the least time (`work.kernel_calls` of every request in
    the window, each call's bound at the given peaks) over the device time
    of the kernels named, or None where the trace holds none of them.  Where
    the profiler kept fewer records than the wrappers' `counters` counted,
    the device time is scaled up by launches over records."""
    if run.trace is None:
        return None
    bound = sum(n * kernels.bound_s(w, mac_flops_per_s, flops_per_s, bytes_per_s)
                for (kind, rows), n in sizes(run).items()
                for g, w in run.work.kernel_calls(run.cfg, kind, rows) if g == group)
    ns = records = 0
    for name in kernel_names:
        t, n = run.trace.kernel(name)
        ns, records = ns + t, records + n
    if records == 0 or bound == 0:
        return None
    launched = sum(run.launched.get(c, 0) for c in counters)
    return 100.0 * bound / (ns / 1e9 * max(launched, records) / records)
