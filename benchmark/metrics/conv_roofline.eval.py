"""conv_roofline.eval: the convolutions' least time over their device time
in the traced window.  Every multiply-add of the image model is a
conditioner's conv (`work/<network>.py::model_flops`), bounded at the
card's dense TF32 peak, which no float32-accurate scheme passes; the time
is that of cuDNN's kernels: the convs and the layout conversions cuDNN
runs around them."""
import re

from benchmark.readers import sizes

TF32_FLOPS_PER_S = 495e12   # H100 SXM, dense TF32, 700 W
CUDNN = re.compile(r"cudnn|xmma|cutlass|convolve|gemm|winograd")


def read(run):
    if run.trace is None or run.cfg["datatype"] != "image":
        return None
    ns, n = run.trace.matching(CUDNN)
    if n == 0:
        return None
    flops = sum(n * run.work.model_flops(run.cfg, kind, rows)
                for (kind, rows), n in sizes(run).items())
    return 100.0 * flops / TF32_FLOPS_PER_S / (ns / 1e9)
