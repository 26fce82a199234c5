"""idle_share.eval: the share of the traced window in which no operation
runs on the device: one minus the union of the trace's kernel, copy and
set intervals over the window."""
from benchmark.readers import window_s


def read(run):
    if run.trace is None:
        return None
    t0, t1 = run.window_ns
    return 100.0 * (1.0 - run.trace.busy_ns(t0, t1) / 1e9 / window_s(run))
