// Fused scaled dot-product attention forward, Hopper (sm_90a).
//
// Replaces nf_tpu/ops/pallas/attention.py::_attn_kernel (launched by
// attention_pallas): for each (batch * head) slice of q, k, v (BH, L, D),
//   out = softmax(q k^T / sqrt(D)) v
// in f32, with the L x L scores never written to device memory (the
// TPU kernel's whole point, which this one keeps).
//
// Bound (H100 SXM): per slice 2 L^2 D multiply-adds for q k^T and as many
// for p v (4 L^2 D flops), 3 f32 operations and one exp per score, and q,
// k, v, out moved once (16 L D bytes).  For image Flow++ at 32x32x1,
// B = 1024 (BH = 4096, D = 8): L = 256 is bound by operations (about 0.14
// ms a call at 67 TFLOP/s f32), L = 64 and L = 16 by bytes (about 10 us and
// 2.5 us at 3.35 TB/s).
//
// Design (a simple kernel first; wgmma, TMA and tensor cores do not pay at
// D = 8).
//  * One thread per query row, its q row and its D accumulators in
//    registers (D is a template parameter: 2, 4, 8, 16, 32 or 64).
//  * A block takes S slices (S = 128 / L for short sequences, so a block
//    still runs at least 128 threads: 8 slices at L = 16, 2 at L = 64) and
//    up to R = 256 query rows of each; longer sequences split their rows
//    over gridDim.y blocks.  Rows past L and slices past BH idle but take
//    part in the staging and the barriers.
//  * The block stages keys and values in shared memory, a tile of T keys
//    of all its slices at a time (2 S T D floats, at most 32 KB: the whole
//    slice at D = 8 and L <= 256, 16 KB at L = 256).  Every thread of a
//    slice reads the same key row, a shared-memory broadcast.
//  * Two passes over the keys, nf_tpu's max-subtract-then-normalise order
//    with the division moved last: pass one takes the row maximum m of the
//    scores; pass two sums exp(s - m) v and exp(s - m); then one division.
//    The scores are recomputed in pass two rather than stored.  With a
//    single tile the keys staged in pass one stay for pass two.
//  * Numerics: accurate expf (no fast math); the scale is 1 / sqrt(D)
//    multiplied in, where the plain version divides by sqrt(D): the two
//    differ only in rounding.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kTileFloats = 8192;  // 32 KB of shared memory for the staged k and v

template <int D>
__device__ __forceinline__ float dot_row(const float (&qv)[D], const float* __restrict__ kr) {
  float d = 0.f;
  if constexpr (D % 4 == 0) {
#pragma unroll
    for (int i = 0; i < D; i += 4) {
      const float4 t = *reinterpret_cast<const float4*>(kr + i);
      d = fmaf(qv[i], t.x, d);
      d = fmaf(qv[i + 1], t.y, d);
      d = fmaf(qv[i + 2], t.z, d);
      d = fmaf(qv[i + 3], t.w, d);
    }
  } else {
#pragma unroll
    for (int i = 0; i < D; ++i) d = fmaf(qv[i], kr[i], d);
  }
  return d;
}

// Copy keys [j0, j0 + count) of the block's slices [slice0, slice0 + n_slices)
// from src (BH, L, D) into dst laid out [slice][T][D].
template <int D>
__device__ __forceinline__ void stage(float* __restrict__ dst, const float* __restrict__ src,
                                      int slice0, int n_slices, int L, int T, int j0,
                                      int count) {
  const int per_slice = count * D;
  const int total = n_slices * per_slice;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int s = i / per_slice;
    const int e = i - s * per_slice;
    dst[s * T * D + e] = src[(static_cast<size_t>(slice0 + s) * L + j0) * D + e];
  }
}

template <int D>
__global__ void __launch_bounds__(kMaxThreads)
    attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out, int BH, int L,
                         int S, int R, int T, float scale) {
  extern __shared__ float4 smem4[];
  float* ks = reinterpret_cast<float*>(smem4);
  float* vs = ks + S * T * D;

  const int s = threadIdx.x / R;
  const int slice0 = blockIdx.x * S;
  const int slice = slice0 + s;
  const int row = blockIdx.y * R + (threadIdx.x - s * R);
  const bool active = s < S && slice < BH && row < L;
  const int n_slices = min(S, BH - slice0);
  const float* kr_base = ks + s * T * D;
  const float* vr_base = vs + s * T * D;

  float qv[D];
  const size_t at = (static_cast<size_t>(slice) * L + row) * D;
#pragma unroll
  for (int i = 0; i < D; ++i) qv[i] = 0.f;
  if (active) {
#pragma unroll
    for (int i = 0; i < D; ++i) qv[i] = q[at + i];
  }

  const int n_tiles = (L + T - 1) / T;

  // pass one: the row maximum of the scores
  float m = -INFINITY;
  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * T;
    const int count = min(T, L - j0);
    stage<D>(ks, k, slice0, n_slices, L, T, j0, count);
    __syncthreads();
    if (active)
      for (int j = 0; j < count; ++j) m = fmaxf(m, dot_row<D>(qv, kr_base + j * D) * scale);
    __syncthreads();
  }

  // pass two: sum exp(s - m) v and exp(s - m)
  float l = 0.f;
  float acc[D];
#pragma unroll
  for (int i = 0; i < D; ++i) acc[i] = 0.f;
  for (int t = 0; t < n_tiles; ++t) {
    const int j0 = t * T;
    const int count = min(T, L - j0);
    if (n_tiles > 1) stage<D>(ks, k, slice0, n_slices, L, T, j0, count);
    stage<D>(vs, v, slice0, n_slices, L, T, j0, count);
    __syncthreads();
    if (active) {
      for (int j = 0; j < count; ++j) {
        const float e = expf(dot_row<D>(qv, kr_base + j * D) * scale - m);
        l += e;
        const float* vr = vr_base + j * D;
#pragma unroll
        for (int i = 0; i < D; ++i) acc[i] = fmaf(e, vr[i], acc[i]);
      }
    }
    __syncthreads();
  }
  if (active) {
#pragma unroll
    for (int i = 0; i < D; ++i) out[at + i] = acc[i] / l;
  }
}

template <int D>
cudaError_t launch(const float* q, const float* k, const float* v, float* out, int BH, int L,
                   int S, int R, int T, cudaStream_t st) {
  const int threads = ((S * R + 31) / 32) * 32;
  const dim3 grid((BH + S - 1) / S, (L + R - 1) / R);
  const size_t smem = sizeof(float) * 2 * S * T * D;
  const float scale = 1.f / sqrtf(static_cast<float>(D));
  attention_fwd_kernel<D><<<grid, threads, smem, st>>>(q, k, v, out, BH, L, S, R, T, scale);
  return cudaGetLastError();
}

}  // namespace

// out (BH, L, D) from contiguous float32 q, k, v (BH, L, D), D in {2, 4, 8,
// 16, 32, 64}, with the tiling S (slices per block), R (query rows of a
// slice per block) and T (keys per staged tile) of ops/cuda/attention.py's
// tiling().  Returns cudaGetLastError() after the launch.
extern "C" int nf_attention_fwd(const void* q, const void* k, const void* v, void* out, int BH,
                                int L, int D, int S, int R, int T, void* stream) {
  if (BH <= 0) return 0;
  if (L <= 0 || S <= 0 || R <= 0 || T <= 0 || T > L || S * R > kMaxThreads ||
      2 * S * T * D > kTileFloats)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(out);
  switch (D) {
    case 2: return (int)launch<2>(qf, kf, vf, of, BH, L, S, R, T, st);
    case 4: return (int)launch<4>(qf, kf, vf, of, BH, L, S, R, T, st);
    case 8: return (int)launch<8>(qf, kf, vf, of, BH, L, S, R, T, st);
    case 16: return (int)launch<16>(qf, kf, vf, of, BH, L, S, R, T, st);
    case 32: return (int)launch<32>(qf, kf, vf, of, BH, L, S, R, T, st);
    case 64: return (int)launch<64>(qf, kf, vf, of, BH, L, S, R, T, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
