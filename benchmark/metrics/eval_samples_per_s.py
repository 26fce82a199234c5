"""eval_samples_per_s: every row answered in the window (log p rows and
sampled rows) over all the window's time, host clock."""
from benchmark.readers import window_s


def read(run):
    return sum(r.rows for r in run.requests) / window_s(run)
