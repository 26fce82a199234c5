"""host_ms_per_request: the median, over the requests of a traced run's
untraced first half, of the host's time from the call to its return,
before the synchronize: the served program's dispatch (EvalProgram, the
kernel wrappers or the eager chain's Python) with no profiler on."""
import statistics


def read(run):
    if not run.untraced:
        return None
    return statistics.median((r.t_return - r.t_call) / 1e6 for r in run.untraced)
