// Entry point of the RealNVP / Glow FFMA stack kernel's WIDE variant
// (fused_stack.cuh: the D-wide header rows and the Glow mix read from
// device memory, the x tile and head rows in device scratch), for a D that
// passes one block's shared memory at fused_stack.py's NARROW_TILE too.
// Replaces nf_tpu/ops/pallas/fused_stack.py::_make_kernels at those
// shapes; its bound and design are stated in fused_stack.cuh.

#include "fused_stack.cuh"

// Plain C entry point: launches one direction on `stream` and returns the
// cudaError_t of the launch (0 on success).  samples / ts must be
// NARROW_TILE's (16, 2) and fp one of TILES' widths; scratch ceil(B / 16)
// blocks of scratch_floats(16, D) floats of device memory; `mix` is read
// only when has_mix is set.
extern "C" int nf_fused_stack_wide(const void* x, void* y, void* ld, const void* pre,
                                   const void* mix, const void* w0t, const void* vec,
                                   const void* wrt, const void* wh, const void* bh,
                                   const void* gb, void* scratch, int B, int D, int n, int fp,
                                   int samples, int ts, int inverse, int has_mix,
                                   float ld_const, void* stream) {
  if ((has_mix && mix == nullptr) || scratch == nullptr || samples != 16 || ts != 2)
    return (int)cudaErrorInvalidValue;
  const Params prm =
      params_of(x, y, ld, pre, mix, w0t, vec, wrt, wh, bh, gb, scratch, B, D, n, ld_const);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool inv = inverse != 0, mx = has_mix != 0;
#define NF_WIDE(FP_) \
  if (fp == FP_) return (int)launch_dir<FP_, 16, 2, true>(prm, inv, mx, st);
  NF_WIDE(8)
  NF_WIDE(16)
  NF_WIDE(32)
  NF_WIDE(64)
  NF_WIDE(128)
  NF_WIDE(256)
#undef NF_WIDE
  return (int)cudaErrorInvalidValue;
}
