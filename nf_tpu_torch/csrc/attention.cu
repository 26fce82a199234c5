// Fused scaled dot-product attention forward, Hopper (sm_90a).
//
// Replaces nf_tpu/ops/pallas/attention.py::_attn_kernel (launched by
// attention_pallas): for each (batch * head) slice of q, k, v (BH, L, D),
//   out = softmax(q k^T / sqrt(D)) v
// in f32, with the L x L scores never written to device memory (the
// TPU kernel's whole point, which this one keeps).
//
// Bound (H100 SXM): per slice 2 L^2 D multiply-adds for q k^T and as many
// for p v, 3 f32 operations and one exp per score, and q, k, v, out moved
// once (16 L D bytes).  For image Flow++ at 32x32x1, B = 1024 (BH = 4096,
// D = 8): L = 256 is bound by operations (0.14 ms a call with the products
// at the 67 TFLOP/s f32 FFMA rate; about 0.064 ms with them on the tensor
// cores at 165 TFLOP/s for f32-accurate 3xTF32, where the products and the
// exps on the SFUs take about the same time), L = 64 and L = 16 by bytes
// (about 10 us and 2.5 us at 3.35 TB/s).
//
// The TPU kernel holds an (L, L) score tile in VMEM and lets the MXU do
// both products.  Hopper's counterpart of the MXU is the tensor cores, and
// its scarce resource here is issued instructions and the latency between
// them, not memory: a thread per query row with FFMA chains (this file's
// first design) spent about 50 instructions a score.  This design:
//  * One pass with an online softmax: a running row maximum m and sum l;
//    per chunk of KT = 64 keys (32 past DP = 64) the chunk's scores, their
//    maximum, one rescale of l and of the accumulators by 2^(m_old -
//    m_new), then 2^(s - m) and the p v product.  Each score is computed
//    once.  A full chunk runs branch-free (one template instance), so the
//    compiler interleaves its 8 key groups' loads, splits and mma.
//  * Both products on tensor cores, mma.sync.m16n8k8 in TF32 with the
//    3xTF32 split for f32 accuracy: x = big + small with big in TF32 and
//    small = x - big, a b ~ big big + big small + small big (the small
//    products first), accumulated in f32.  Plain TF32 keeps about three
//    digits and would change what the kernel computes.  q and v round
//    their big part to nearest, k and p truncate it (split<> in
//    tf32_split.cuh).
//    A warp owns 16 query rows of one slice.  q k^T takes 8 keys (n) and a
//    k = 8 slab of D per mma; p v takes 8 keys (k) into 8 columns of D (n).
//    The score fragment (rows g, g + 8; keys 2t, 2t + 1 of lane 4g + t) is
//    reused as p v's A fragment by pairing the mma's k index t with key 2t
//    and t + 4 with key 2t + 1, and reading v's rows in the same pairing,
//    so p never leaves registers.  At small D the p v products go to
//    4 / NK copies of the accumulators in turn, so that several mma chains
//    are in flight.
//  * exp: q is staged prescaled by log2(e) / sqrt(D), so a score is
//    already in log2 units and p = 2^(s - m) is one ex2.approx on the SFU
//    (what exp2f becomes under fast math).  It holds atol / rtol 1e-5
//    against the plain version in every card check (its worst error, 5.7e-6
//    at (64, 1500, 8), is below the accurate-expf first version's 1.9e-5).
//  * Any D from 1 to 128, zero-padded to DP, a multiple of 8 (a template
//    parameter): the zero columns add nothing to q k^T and are not stored.
//    Past 128, csrc/attention_wide.cu.
//    q's fragments stay in registers, split once, up to DP = 64; wider q
//    stays in the warp's shared rows and is read and split at each use, so
//    the accumulators and scores keep their registers.
//  * Blocks of 4 warps, 64 query rows: S slices of R rows each (L <= 16:
//    4 slices of one warp; L <= 32: 2 slices of 2 warps; longer: 64 rows of
//    one slice, ceil(L / 64) neighbouring blocks).  Keys and values are
//    staged in shared memory T keys at a time with cp.async (16 bytes a
//    copy when D % 4 == 0 and the tensors are 16-byte aligned, else 4):
//    the whole slice at once where it fits (L = 256 at D = 8: 24 KB), else
//    double-buffered tiles; every warp of a slice reads the same staged
//    keys, and a block meets one barrier per tile.  Rows are padded to DP
//    + 4 floats, so the fragment loads meet no bank conflicts.  q is staged
//    and out stored through the warp's own shared rows, in 16-byte steps
//    where D allows.  ops/cuda/attention.py::tiling picks S, R and T.
//  * Keys past L in the last chunk score -inf (p = 0); staged rows and
//    columns past the data are zero-filled first, so no NaN can meet p = 0.
//  * out = acc / l at the end (IEEE division).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

#include "tf32_split.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16;                   // query rows of a warp: the mma's m
constexpr int kBlockRows = kRows * kWarps;  // query rows of a block
constexpr size_t kSmemLimit = 232448;       // dynamic shared memory of one block

// keys per softmax step (their scores stay in registers), and the padded
// row stride of the staged rows
__host__ __device__ constexpr int key_chunk(int DP) { return DP <= 64 ? 64 : 32; }
__host__ __device__ constexpr int stride_of(int DP) { return DP + 4; }

__host__ __device__ constexpr size_t smem_floats(int DP, int S, int T, bool two_buffers) {
  return (size_t)stride_of(DP) * (kBlockRows + (two_buffers ? 2 : 1) * 2 * S * T);
}

// Copy rows [j0, j0 + count) of slices [slice0, slice0 + n_slices) of src
// (BH, L, D) into dst [slice][T][ST] with cp.async, by the whole block.
template <int DP>
__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src, int slice0,
                                      int n_slices, int L, int D, int T, int j0, int count,
                                      bool vec) {
  constexpr int ST = stride_of(DP);
  const int W = vec ? DP / 4 : DP;  // copies per padded row
  for (int i = threadIdx.x; i < n_slices * T * W; i += kThreads) {
    const int row = vec ? i / (DP / 4) : i / DP;  // [slice][T] rows
    const int c = (i - row * W) * (vec ? 4 : 1);
    const int s = row / T, r = row - s * T;
    if (r >= count || c >= D) continue;
    const float* from = src + (static_cast<size_t>(slice0 + s) * L + j0 + r) * D + c;
    if (vec)
      __pipeline_memcpy_async(dst + row * ST + c, from, 16);
    else
      __pipeline_memcpy_async(dst + row * ST + c, from, 4);
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads)
    attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ out, int BH, int L,
                         int D, int S, int R, int T, float scale, bool vec) {
  constexpr int ST = stride_of(DP);
  constexpr int KT = key_chunk(DP);
  constexpr int NK = DP / 8;  // k-steps of q k^T, n-tiles of p v
  constexpr bool kQInRegs = DP <= 64;
  constexpr int NA = NK >= 4 ? 1 : 4 / NK;
  extern __shared__ __align__(16) float smem[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wps = R / kRows;  // warps per slice
  const int s_local = warp / wps;
  // a slice's row blocks are neighbours in launch order, so they run
  // together and read its keys and values from L2
  const int row_blocks = (L + R - 1) / R;
  const int slice0 = (blockIdx.x / row_blocks) * S;
  const int slice = slice0 + s_local;
  const int row0 = (blockIdx.x % row_blocks) * R + (warp - s_local * wps) * kRows;
  const int n_slices = min(S, BH - slice0);
  const bool active = slice < BH && row0 < L;  // uniform in the warp
  const int n_tiles = (L + T - 1) / T;
  const int tile_floats = S * T * ST;
  float* rows = smem + warp * kRows * ST;  // this warp's q rows, then its out rows
  float* kv = smem + kBlockRows * ST;      // [buffer][k, v][slice][T][ST]

  if (D != DP || L % T != 0) {
    const int n = (n_tiles > 1 ? 4 : 2) * tile_floats;
    for (int i = threadIdx.x; i < n; i += kThreads) kv[i] = 0.f;
    __syncthreads();
  }
  auto stage_tile = [&](int tile) {
    const int j0 = tile * T;
    const int count = min(T, L - j0);
    float* base = kv + (tile & 1) * 2 * tile_floats;
    stage<DP>(base, k, slice0, n_slices, L, D, T, j0, count, vec);
    stage<DP>(base + tile_floats, v, slice0, n_slices, L, D, T, j0, count, vec);
  };
  stage_tile(0);
  __pipeline_commit();

  // q rows through shared memory into A fragments: a0 (g, t), a1 (g + 8, t),
  // a2 (g, t + 4), a3 (g + 8, t + 4) of each 16 x 8 slab
  const size_t at = (static_cast<size_t>(slice) * L + row0) * D;
  if (active) {
    if (vec) {
      for (int e = lane; e < kRows * DP / 4; e += 32) {
        const int r = e / (DP / 4), c = 4 * (e - r * (DP / 4));
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (row0 + r < L && c < D) x = *reinterpret_cast<const float4*>(q + at + r * D + c);
        *reinterpret_cast<float4*>(rows + r * ST + c) =
            make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
      }
    } else {
      for (int e = lane; e < kRows * DP; e += 32) {
        const int r = e / DP, c = e - r * DP;
        rows[r * ST + c] = (row0 + r < L && c < D) ? q[at + r * D + c] * scale : 0.f;
      }
    }
  }
  __syncwarp();
  auto q_fragment = [&](int ks, uint32_t (&ab)[4], uint32_t (&as)[4]) {
    split<true>(rows[g * ST + ks * 8 + t], ab[0], as[0]);
    split<true>(rows[(g + 8) * ST + ks * 8 + t], ab[1], as[1]);
    split<true>(rows[g * ST + ks * 8 + t + 4], ab[2], as[2]);
    split<true>(rows[(g + 8) * ST + ks * 8 + t + 4], ab[3], as[3]);
  };
  uint32_t qb[kQInRegs ? NK : 1][4], qsm[kQInRegs ? NK : 1][4];
  if constexpr (kQInRegs) {
#pragma unroll
    for (int ks = 0; ks < NK; ++ks) q_fragment(ks, qb[ks], qsm[ks]);
  }

  float o[NA][NK][4];  // copy nt % NA takes key group nt: NA independent mma chains
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int dn = 0; dn < NK; ++dn)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[a][dn][i] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows g and g + 8

  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles) stage_tile(tile + 1);
    __pipeline_commit();
    __pipeline_wait_prior(1);  // tile's copies have landed
    __syncthreads();
    const int n_keys = min(T, L - tile * T);
    const float* kt_ = kv + (tile & 1) * 2 * tile_floats + s_local * T * ST;
    // one chunk of up to KT keys of the staged tile: FULL (KT keys) runs
    // branch-free, so the compiler can interleave the key groups' loads,
    // splits and mma
    auto chunk = [&](auto full, const float* ks_, int count) {
      constexpr bool FULL = decltype(full)::value;
      const float* vs_ = ks_ + tile_floats;
      // scores of the tile: B fragment b0 (key g, dim t), b1 (key g, dim t + 4)
      float sc[KT / 8][4];
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < KT / 8; ++nt) {
        if (FULL || nt * 8 < count) {
          float c[4] = {0.f, 0.f, 0.f, 0.f};
          const float* kr = ks_ + (nt * 8 + g) * ST + t;
#pragma unroll
          for (int ks = 0; ks < NK; ++ks) {
            uint32_t bb[2], bs[2];
            split_b<false>(kr[ks * 8], kr[ks * 8 + 4], bb, bs);
            if constexpr (kQInRegs) {
              mma3(c, qb[ks], qsm[ks], bb, bs);
            } else {
              uint32_t ab[4], as[4];
              q_fragment(ks, ab, as);
              mma3(c, ab, as, bb, bs);
            }
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) sc[nt][i] = c[i];
          if (!FULL && (count & 7)) {  // the last tile's last key group is ragged
            const int key = nt * 8 + 2 * t;
            if (key >= count) sc[nt][0] = sc[nt][2] = -INFINITY;
            if (key + 1 >= count) sc[nt][1] = sc[nt][3] = -INFINITY;
          }
          mx0 = fmaxf(mx0, fmaxf(sc[nt][0], sc[nt][1]));
          mx1 = fmaxf(mx1, fmaxf(sc[nt][2], sc[nt][3]));
        }
      }
      // the row maximum over the quad that holds the row
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float al0 = ex2(m0 - mn0), al1 = ex2(m1 - mn1);  // 0 on the first tile
      m0 = mn0;
      m1 = mn1;
      l0 *= al0;
      l1 *= al1;
#pragma unroll
      for (int a = 0; a < NA; ++a)
#pragma unroll
        for (int dn = 0; dn < NK; ++dn) {
          o[a][dn][0] *= al0;
          o[a][dn][1] *= al0;
          o[a][dn][2] *= al1;
          o[a][dn][3] *= al1;
        }
      // p v: A fragment (k index t <-> key 2t, t + 4 <-> key 2t + 1) is the
      // score fragment; B fragment b0 (key 2t, column g), b1 (key 2t + 1, g)
#pragma unroll
      for (int nt = 0; nt < KT / 8; ++nt) {
        if (FULL || nt * 8 < count) {
          const float p0 = ex2(sc[nt][0] - m0), p1 = ex2(sc[nt][1] - m0);
          const float p2 = ex2(sc[nt][2] - m1), p3 = ex2(sc[nt][3] - m1);
          l0 += p0 + p1;
          l1 += p2 + p3;
          uint32_t pb[4], ps[4];
          split<false>(p0, pb[0], ps[0]);
          split<false>(p2, pb[1], ps[1]);
          split<false>(p1, pb[2], ps[2]);
          split<false>(p3, pb[3], ps[3]);
          const float* vr = vs_ + (nt * 8 + 2 * t) * ST + g;
#pragma unroll
          for (int dn = 0; dn < NK; ++dn) {
            uint32_t bb[2], bs[2];
            split_b<true>(vr[dn * 8], vr[ST + dn * 8], bb, bs);
            mma3(o[nt % NA][dn], pb, ps, bb, bs);
          }
        }
      }
    };
    if (active) {
      for (int c0 = 0; c0 < n_keys; c0 += KT) {
        if (n_keys - c0 >= KT)
          chunk(std::true_type{}, kt_ + c0 * ST, KT);
        else
          chunk(std::false_type{}, kt_ + c0 * ST, n_keys - c0);
      }
    }
    __syncthreads();  // the buffer is free for tile + 2
  }

  if (!active) return;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  // C fragment: c0, c1 (row g, columns 2t, 2t + 1), c2, c3 (row g + 8)
#pragma unroll
  for (int a = 1; a < NA; ++a)
#pragma unroll
    for (int dn = 0; dn < NK; ++dn)
#pragma unroll
      for (int i = 0; i < 4; ++i) o[0][dn][i] += o[a][dn][i];
#pragma unroll
  for (int dn = 0; dn < NK; ++dn) {
    *reinterpret_cast<float2*>(rows + g * ST + dn * 8 + 2 * t) =
        make_float2(o[0][dn][0] / l0, o[0][dn][1] / l0);
    *reinterpret_cast<float2*>(rows + (g + 8) * ST + dn * 8 + 2 * t) =
        make_float2(o[0][dn][2] / l1, o[0][dn][3] / l1);
  }
  __syncwarp();
  if (vec) {
    for (int e = lane; e < kRows * DP / 4; e += 32) {
      const int r = e / (DP / 4), c = 4 * (e - r * (DP / 4));
      if (row0 + r < L && c < D)
        *reinterpret_cast<float4*>(out + at + r * D + c) =
            *reinterpret_cast<const float4*>(rows + r * ST + c);
    }
  } else {
    for (int e = lane; e < kRows * DP; e += 32) {
      const int r = e / DP, c = e - r * DP;
      if (row0 + r < L && c < D) out[at + r * D + c] = rows[r * ST + c];
    }
  }
}

template <int DP>
cudaError_t launch(const float* q, const float* k, const float* v, float* out, int BH, int L,
                   int D, int S, int R, int T, bool vec, cudaStream_t st) {
  const size_t smem = sizeof(float) * smem_floats(DP, S, T, L > T);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  auto kernel = attention_fwd_kernel<DP>;
  static size_t opted_in = 48 * 1024;  // above 48 KB a block needs the opt-in
  if (smem > opted_in) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  const unsigned grid = (unsigned)((BH + S - 1) / S) * (unsigned)((L + R - 1) / R);
  const float scale = 1.4426950408889634f / sqrtf(static_cast<float>(D));  // log2(e) / sqrt(D)
  kernel<<<grid, kThreads, smem, st>>>(q, k, v, out, BH, L, D, S, R, T, scale, vec);
  return cudaGetLastError();
}

}  // namespace

// out (BH, L, D) from contiguous float32 q, k, v (BH, L, D), 1 <= D <= 128,
// with the tiling S (slices per block), R (query rows of a slice per block)
// and T (keys per staged tile) of ops/cuda/attention.py's tiling(); vec: D
// is a multiple of 4 and every pointer 16-byte aligned.  Returns
// cudaGetLastError() after the launch.
extern "C" int nf_attention_fwd(const void* q, const void* k, const void* v, void* out, int BH,
                                int L, int D, int S, int R, int T, int vec, void* stream) {
  if (BH <= 0) return 0;
  if (L <= 0 || D < 1 || D > 128 || S <= 0 || R % kRows != 0 || S * R != kBlockRows ||
      T <= 0 || T % 8 != 0 || (vec && D % 4 != 0) ||
      (long long)((BH + S - 1) / S) * ((L + R - 1) / R) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(out);
  switch ((D + 7) / 8) {
#define NF_DP(N) \
  case N: return (int)launch<8 * N>(qf, kf, vf, of, BH, L, D, S, R, T, vec != 0, st);
    NF_DP(1) NF_DP(2) NF_DP(3) NF_DP(4) NF_DP(5) NF_DP(6) NF_DP(7) NF_DP(8)
    NF_DP(9) NF_DP(10) NF_DP(11) NF_DP(12) NF_DP(13) NF_DP(14) NF_DP(15) NF_DP(16)
#undef NF_DP
    default: return (int)cudaErrorInvalidValue;
  }
}
