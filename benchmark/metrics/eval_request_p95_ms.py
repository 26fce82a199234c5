"""eval_request_p95_ms: the 95th percentile over all the window's requests
of the time from the call to the end of its synchronize, host clock."""
import statistics


def read(run):
    ms = [(r.t_end - r.t_call) / 1e6 for r in run.requests]
    if len(ms) < 20:
        return None
    return statistics.quantiles(ms, n=100)[94]
