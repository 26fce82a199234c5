"""launch_lag_us.eval: how long after its wrapper was called a port kernel
starts on the device, in microseconds: the median, over the traced
window's port kernel launches, of the kernel's device start less its
`launch.*` span's start.  The n-th launch span of the window launched the
n-th port kernel record (one stream, one kernel a launch: spans.matched)."""
from benchmark.spans import clock_check


def read(run):
    return clock_check(run).get("lag_us_median")
