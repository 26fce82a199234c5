"""mfu.eval: the model's multiply-adds (2 flops each; `work/<network>.py`)
of every request in the traced window, over the window's time at the card's
dense TF32 peak: no float32-accurate scheme runs above it."""
from benchmark.readers import sizes, window_s

TF32_FLOPS_PER_S = 495e12   # H100 SXM, dense TF32, 700 W


def read(run):
    if run.trace is None:
        return None
    flops = sum(n * run.work.model_flops(run.cfg, kind, rows)
                for (kind, rows), n in sizes(run).items())
    return 100.0 * flops / (window_s(run) * TF32_FLOPS_PER_S)
