"""eval_self_us.spans: the served program's own host time a request, in
microseconds: the self time of its root span (`EvalProgram.log_prob` or
`.sample`) plus its `EvalProgram.input`, `.draw` and `.logp` spans (the
input's move, the base draw, the log-density's epilogue), the median over
the requests of the host's phase (spans recorded, no profiler on)."""
import statistics
from collections import defaultdict

from benchmark.spans import EVAL, host_phase, self_ns


def read(run):
    phase = host_phase(run)
    if phase is None:
        return None
    idx, _ = phase
    own = self_ns(run.spans)
    by = defaultdict(int)
    for i in idx:
        name, _, _, _, request = run.spans[i]
        if name in EVAL and request >= 0:
            by[request] += own[i]
    return statistics.median(by.values()) / 1e3 if by else None
