"""chain_self_us_per_image.spans: the eager chain's own Python a served
image costs the host, in microseconds: the self time of every `layer.*`
span (core/bijector.py's call_forward / call_inverse: each layer and each
container) and of the couplings' `coupling.split` / `.merge` spans, over
the images the host's phase served (spans recorded, no profiler on)."""
from benchmark.spans import CHAIN, host_phase, self_ns


def read(run):
    phase = host_phase(run)
    if phase is None:
        return None
    idx, images = phase
    own = self_ns(run.spans)
    ns = [own[i] for i in idx
          if run.spans[i][0].startswith("layer.") or run.spans[i][0] in CHAIN]
    return sum(ns) / 1e3 / images if ns and images else None
