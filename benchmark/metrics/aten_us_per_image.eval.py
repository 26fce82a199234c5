"""aten_us_per_image.eval: the device microseconds a served image spends in
ATen's own kernels in the traced window: the eager chain's strided copies
(permuted NHWC views, the checkerboard's splits and merges, `cat`), its
batch norms and elementwise work, over the images the window served."""
import re

ATEN = re.compile(r"at::native::|at_cuda_detail::")


def read(run):
    if run.trace is None:
        return None
    ns, n = run.trace.matching(ATEN)
    images = sum(r.rows for r in run.requests)
    if n == 0 or images == 0:
        return None
    return ns / 1e3 / images
