"""fused_stack_roofline.eval: the fused stack kernels' least time
(`work/kernels.py::stack_work` at each request's rows) over their device
time in the trace (csrc/fused_stack_mma.cu, fused_stack.cuh,
fused_stack_wide.cu, whichever the program launched)."""
from benchmark.readers import roofline

TF32_FLOPS_PER_S = 495e12   # multiply-adds: H100 SXM dense TF32
F32_FLOPS_PER_S = 67e12     # other float32 operations: the FFMA rate
HBM_BYTES_PER_S = 3.35e12
KERNELS = ("fused_stack_mma_kernel", "fused_stack_kernel", "fused_stack_cluster_kernel")
COUNTERS = ("fused_stack_fwd", "fused_stack_inv", "fused_stack_glow_fwd", "fused_stack_glow_inv")


def read(run):
    return roofline(run, "fused_stack", KERNELS, COUNTERS, TF32_FLOPS_PER_S, F32_FLOPS_PER_S,
                    HBM_BYTES_PER_S)
