"""The traced run's device trace: torch.profiler over the traced window.

`Profiler` records the card's activity (kernels, copies, sets) with
CUPTI and, once stopped, holds each device operation as (name, start,
end) in nanoseconds of the host's `time.perf_counter_ns` clock, so the
benchmark's own spans (its requests) and the device's operations share one
time line.  The profiler's base is matched to that clock at start (the
wall clock or the monotonic one, whichever the trace's start lies next
to), then shifted so that the host-side synchronizations it recorded end
where the benchmark saw its requests' synchronizes return (`clock_shift`).

From these: the busy time (the union of the operations' intervals), the
idle gaps and what the host was doing in each (the span it was in), the
longest operations by name, and each kernel's device time and count.
"""
from __future__ import annotations

import bisect
import re
import time
from collections import defaultdict
from dataclasses import dataclass, field


@dataclass
class DeviceTrace:
    ops: list                      # (name, start_ns, end_ns), host perf clock, sorted
    clock: str                     # which host clock the profiler's base matched
    runtime_syncs: list            # end_ns of each host-side synchronization it saw
    _union: list = field(default=None, repr=False)
    _by_name: dict = field(default=None, repr=False)

    def union(self):
        """The operations' intervals merged: [(start, end)], sorted."""
        if self._union is None:
            merged = []
            for _, s, e in self.ops:
                if merged and s <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], e)
                else:
                    merged.append([s, e])
            self._union = merged
        return self._union

    def busy_ns(self, t0: int, t1: int) -> int:
        return sum(max(0, min(e, t1) - max(s, t0)) for s, e in self.union())

    def gaps(self, t0: int, t1: int):
        """Idle intervals inside [t0, t1]: [(start, end)]."""
        out, at = [], t0
        for s, e in self.union():
            if e <= t0:
                continue
            if s >= t1:
                break
            if s > at:
                out.append((at, s))
            at = max(at, e)
        if at < t1:
            out.append((at, t1))
        return out

    def by_name(self):
        """{operation name: [device ns of each]}, built once."""
        if self._by_name is None:
            self._by_name = defaultdict(list)
            for n, s, e in self.ops:
                self._by_name[n].append(e - s)
        return self._by_name

    def durations(self, name: str):
        """Device ns of each operation named for kernel `name`."""
        pat = re.compile(rf"\b{re.escape(name)}\b")
        return [d for n, ds in self.by_name().items() if pat.search(n) for d in ds]

    def kernel(self, name: str):
        """(device ns, count) of the operations named for kernel `name`."""
        hits = self.durations(name)
        return sum(hits), len(hits)

    def matching(self, pattern):
        """(device ns, count) of the operations whose names `pattern` (a
        compiled regular expression) finds."""
        hits = [d for n, ds in self.by_name().items() if pattern.search(n) for d in ds]
        return sum(hits), len(hits)

    def top_ops(self, k: int = 10):
        """[[short name, seconds]]: the k operations that took most device
        time, summed by name."""
        by = defaultdict(int)
        for n, ds in self.by_name().items():
            by[short_name(n)] += sum(ds)
        top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
        return [[n, ns / 1e9] for n, ns in top]


def short_name(name: str) -> str:
    """A kernel's name without its return type, template arguments and
    parameters, cut to 64 characters."""
    name = re.sub(r"^void\s+", "", name)
    depth, out = 0, []
    for ch in name:
        if ch in "<(":
            depth += 1
        elif ch in ">)":
            depth -= 1
        elif depth == 0:
            out.append(ch)
    return ("".join(out).strip() or name)[:64]


def label_gaps(gaps, spans, k: int = 10):
    """[[host span, idle seconds]] for the k spans in which the device
    idled longest, each gap counted in the span its start fell in; spans
    are (start_ns, label), sorted by start."""
    starts = [s for s, _ in spans]
    by = defaultdict(int)
    for a, b in gaps:
        i = bisect.bisect_right(starts, a) - 1
        by[spans[i][1] if i >= 0 else "before"] += b - a
    top = sorted(by.items(), key=lambda kv: -kv[1])[:k]
    return [[n, ns / 1e9] for n, ns in top]


class Profiler:
    """torch.profiler over the device's activity, aligned to the host's
    perf clock."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self.trace = None

    def __enter__(self):
        self._perf0, self._wall0 = time.perf_counter_ns(), time.time_ns()
        self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        t0 = time.perf_counter_ns()
        self._prof.__exit__(*exc)
        t1 = time.perf_counter_ns()
        if exc[0] is None:
            self.trace = self._read()
            self.stop_s, self.read_s = (t1 - t0) / 1e9, (time.perf_counter_ns() - t1) / 1e9
        return False

    def _read(self) -> DeviceTrace:
        from torch.autograd import DeviceType
        res = self._prof.profiler.kineto_results
        base = (res.trace_start_ns() if hasattr(res, "trace_start_ns")
                else res.trace_start_us() * 1000)
        # the trace's clock in perf-clock ns: the wall clock's or the monotonic one's
        wall = self._perf0 - self._wall0
        clock, to_perf = min((("wall", wall), ("monotonic", 0)),
                             key=lambda c: abs(base + c[1] - self._perf0))
        ops, syncs = [], []
        for e in res.events():      # the raw records: no event tree is built
            s = e.start_ns() + to_perf
            if e.device_type() == DeviceType.CUDA:
                if not getattr(e, "is_user_annotation", lambda: False)():
                    ops.append((e.name(), s, s + e.duration_ns()))
            elif "Synchronize" in e.name():
                syncs.append(s + e.duration_ns())
        ops.sort(key=lambda o: o[1])
        return DeviceTrace(ops, clock, sorted(syncs))


def clock_shift(trace: DeviceTrace, sync_ends) -> int:
    """Shift the trace by the median, over the requests, of the gap from
    the host-side synchronization it recorded nearest each request's
    synchronize return to that return; returns the shift in ns.  The
    device's operations move with it: where CUPTI placed them on the host's
    clock with an offset of its own, that offset stays."""
    ends = trace.runtime_syncs
    if not ends or not sync_ends:
        return 0
    gaps = []
    for t in sync_ends:
        i = bisect.bisect_left(ends, t)
        near = [ends[j] for j in (i - 1, i) if 0 <= j < len(ends)]
        gaps.append(min((t - e for e in near), key=abs))
    gaps.sort()
    shift = gaps[len(gaps) // 2]
    trace.ops = [(n, s + shift, e + shift) for n, s, e in trace.ops]
    trace.runtime_syncs = [e + shift for e in ends]
    trace._union = None
    return shift
