"""launch_host_us.spans: the host's time a kernel launch takes in the
port's wrappers (ops/cuda: the checks, the allocations, the ctypes call),
in microseconds: the median duration of a `launch.*` span over the host's
phase (spans recorded, no profiler on)."""
import statistics

from benchmark.spans import host_phase


def read(run):
    phase = host_phase(run)
    if phase is None:
        return None
    idx, _ = phase
    d = [e - s for n, s, e, _, _ in (run.spans[i] for i in idx) if n.startswith("launch.")]
    return statistics.median(d) / 1e3 if d else None
