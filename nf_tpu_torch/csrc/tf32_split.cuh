// TF32 tensor-core products at f32 accuracy (3xTF32) and the SFU's exp2,
// Hopper (sm_90a).  Shared by the attention kernels: csrc/attention.cu
// (D <= 128, one pass) and csrc/attention_wide.cu (D > 128).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

// 2^x by the SFU's ex2.approx (what exp2f becomes under fast math): one
// instruction where exp2f takes four; it flushes results below 2^-126 to 0
__device__ __forceinline__ float ex2(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

// x = big + small with big in TF32 and small = x - big exactly, left to the
// tensor core, which reads a TF32 operand's top 19 bits.  ROUND: big = x
// rounded to nearest (ties away from zero) on its bits, two instructions
// where cvt.rna.tf32.f32 takes four on sm_90 (the inputs are finite);
// |small| <= 2^-11 |x|.  Else big = x truncated, one instruction;
// |small| < 2^-10 |x|.  Each product rounds one side (q, v) and truncates
// the other (k, p), so the dropped small * small term stays below 2^-21 of
// |a b|, and small's own truncation below 2^-21 of |x|.
template <bool ROUND>
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = ((__float_as_uint(x) + (ROUND ? 0x1000u : 0u)) & 0xffffe000u);
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32, the small products first
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  mma(c, ab, bs);
  mma(c, as, bb);
  mma(c, ab, bb);
}

template <bool ROUND>
__device__ __forceinline__ void split_b(float b0, float b1, uint32_t (&bb)[2],
                                        uint32_t (&bs)[2]) {
  split<ROUND>(b0, bb[0], bs[0]);
  split<ROUND>(b1, bb[1], bs[1]);
}

}  // namespace
