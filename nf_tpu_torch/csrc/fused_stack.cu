// Entry point of the RealNVP / Glow FFMA stack kernel at fused_stack.py's
// TILES and NARROW_TILE tilings.  The kernel, what it replaces
// (nf_tpu/ops/pallas/fused_stack.py::_make_kernels), its bound and its
// design are in fused_stack.cuh; past both tilings the cluster kernel of
// csrc/fused_stack_wide.cu.

#include "fused_stack.cuh"

// Plain C entry point: launches one direction on `stream` and returns the
// cudaError_t of the launch (0 on success).  fp / samples / ts must be one
// of the tilings below, fused_stack.py's TILES or NARROW_TILE; `mix` is
// read only when has_mix is set.
extern "C" int nf_fused_stack(const void* x, void* y, void* ld, const void* pre,
                              const void* mix, const void* w0t, const void* vec,
                              const void* wrt, const void* wh, const void* bh,
                              const void* gb, int B, int D, int n, int fp, int samples,
                              int ts, int inverse, int has_mix, float ld_const,
                              void* stream) {
  if (has_mix && mix == nullptr) return (int)cudaErrorInvalidValue;
  const Params prm =
      params_of(x, y, ld, pre, mix, w0t, vec, wrt, wh, bh, gb, B, D, n, ld_const);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool inv = inverse != 0, mx = has_mix != 0;
#define NF_TILING(FP_, S_, TS_) \
  if (fp == FP_ && samples == S_ && ts == TS_) return (int)launch_dir<FP_, S_, TS_>(prm, inv, mx, st);
  NF_TILING(8, 256, 4)
  NF_TILING(16, 128, 4)
  NF_TILING(32, 64, 2)
  NF_TILING(64, 64, 4)
  NF_TILING(128, 32, 4)
  NF_TILING(256, 32, 4)
  // NARROW_TILE: 16 samples a block, for a D whose x tile and head rows
  // would pass the shared memory at the tilings above
  NF_TILING(8, 16, 2)
  NF_TILING(16, 16, 2)
  NF_TILING(32, 16, 2)
  NF_TILING(64, 16, 2)
  NF_TILING(128, 16, 2)
  NF_TILING(256, 16, 2)
#undef NF_TILING
  return (int)cudaErrorInvalidValue;
}
