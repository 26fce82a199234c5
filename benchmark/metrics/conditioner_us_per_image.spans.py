"""conditioner_us_per_image.spans: the host's time in the couplings'
conditioners a served image costs, in microseconds: the duration of every
`coupling.net` span (nets/: the conv layers, weight norm recomputed on
each call, cuDNN's dispatch, the batch norms), over the images the host's
phase served (spans recorded, no profiler on)."""
from benchmark.spans import host_phase


def read(run):
    phase = host_phase(run)
    if phase is None:
        return None
    idx, images = phase
    ns = [e - s for n, s, e, _, _ in (run.spans[i] for i in idx) if n == "coupling.net"]
    return sum(ns) / 1e3 / images if ns and images else None
