// Fused scaled dot-product attention forward past D = 128, Hopper (sm_90a).
//
// Replaces nf_tpu/ops/pallas/attention.py::_attn_kernel (launched by
// attention_pallas) at head widths past 128, which csrc/attention.cu's
// one-pass kernel does not take: for each (batch * head) slice of q, k, v
// (BH, L, D),
//   out = softmax(q k^T / sqrt(D)) v
// in f32, with the L x L scores never written to device memory.  nf_tpu's
// kernel takes the whole (L, D) slice at any D; GatedAttn's 4 heads give
// D = base_filters / 4.
//
// Bound (H100 SXM): per slice 2 L^2 D multiply-adds for q k^T and as many
// for p v, and q, k, v, out moved once (16 L D bytes): (64, 256, 192) is
// bound by operations (0.0195 ms with both products on the tensor cores
// at 165 TFLOP/s for f32-accurate 3xTF32), (64, 64, 512) by bytes (0.010
// ms at 3.35 TB/s).
//
// The one-pass kernel keeps a warp's 16 x DP accumulators and its chunk's
// scores in registers, so DP cannot grow past 128.  This design splits the
// two products over different warp roles within a block instead of over
// blocks, so each score is computed once:
//  * A block of 16 warps owns BR = 16 RT query rows of one slice (RT row
//    tiles of 16, the mma's m) and walks the slice's keys KT at a time.
//    q's BR rows are staged once per block, prescaled by log2(e) / sqrt(D)
//    (a score is then in log2 units and p = 2^(s - m) is one ex2.approx).
//  * k and v tiles stream through a ring of two stages with cp.async (16
//    bytes a copy when D % 4 == 0 and the tensors are 16-byte aligned, else
//    4): tile j + 1 is issued right after tile j's first barrier and lands
//    while tile j's two products run.  The block's barriers, which the p
//    hand-off needs anyway, stand in for the ring's full / empty barriers.
//  * Scores: the WR = 16 / RT warps of a row tile each contract q k^T over
//    one chunk of D (ceil(DP / 8 / WR) k-steps) for all KT keys of the tile
//    and write the partial 16 x KT block to shared memory.
//  * Softmax: G threads per row sum the WR partial scores in chunk order,
//    take the tile's row maximum (xor shuffles over the G lanes), keep the
//    running maximum and their share of the running sum in registers, and
//    write p = 2^(s - m) over the first partial block and the rescale
//    2^(m_old - m_new) per row.
//  * p v: the same WR warps of a row tile each own a slab of at most 8
//    n-tiles (64 output columns) of all DP columns; their accumulators
//    stay in registers, are rescaled per tile and take p v over the tile's
//    keys.  p's A fragment pairs the mma's k index t with key 2t and t + 4
//    with key 2t + 1, and v's rows are read in the same pairing.
//  * Both products on tensor cores, mma.sync.m16n8k8 in TF32 with the
//    3xTF32 split (tf32_split.cuh): q and v round their big part, k and p
//    truncate it.  A warp issues its products in rounds over 4 (or the
//    tile's KG) independent accumulators, so each round's mma need not
//    wait on the last; each accumulator still takes its small products
//    first, then big by big, as mma3 adds them.
//  * D is zero-padded to DP, a multiple of 8, at run time (one instance
//    per (RT, KT), not per D); rows are padded to DP + 4 floats, so the
//    fragment loads meet no bank conflicts.  Three barriers per tile: the
//    tile has landed, the partial scores are written, p is written.
//  * Tiling (ops/cuda/attention.py::wide_tiling): the most row tiles of
//    (RT, KT) = (4, 32), (2, 16), (1, 8) whose column slabs cover DP
//    (DP <= 1024 / RT), that L fills (16 RT <= L rounded up to 16) and
//    whose block fits shared memory: 4 ((DP + 4)(BR + 4 KT) + WR BR (KT +
//    4) + 2 BR) bytes, 184 KB at (64, 256, 192) (RT = 4, which fits up to
//    DP = 248), 214 KB at (64, 64, 512) (RT = 2), 205 KB at D = 1024
//    (RT = 1), the widest D whose q and k rows it stages.  16 warps rather
//    than 8 (slabs of 8 n-tiles, not 16) ran both of these shapes faster
//    on the H100.
//  * Past DP = 1024 (GROUPS, at (1, 8)) the grid's y takes groups of 1024
//    output columns: a block stages the v rows and out columns of its
//    group only and forms every score itself, each warp over its chunk of
//    all DP / 8 k-steps with q and k read from L2 where they are used (q
//    scaled as it is read, as the staging scales it), so the scores are
//    formed once per group and no shared memory grows with D: any D
//    runs.
//  * Keys past L in the last tile score -inf (p = 0); staged rows and
//    columns past the data are zero-filled, so no NaN can meet p = 0.
//  * out = acc / l at the end (IEEE division), stored through q's rows.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "tf32_split.cuh"

namespace {

constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxTiles = 8;           // n-tiles of one warp's column slab
constexpr int kMaxDim = 1024;          // DP * RT: 16 warps' slabs of 8 n-tiles; a column group
constexpr size_t kSmemLimit = 232448;  // dynamic shared memory of one block

__host__ __device__ constexpr int padded(int D) { return (D + 7) / 8 * 8; }

// floats of one block's shared memory: q [BR][DP + 4], the ring
// [2][k, v][KT][DP + 4], the partial scores [WR][BR][KT + 4] (the first
// block then holds p), the rescales and sums [BR] each; past DP = 1024
// (groups) out [BR][1028] and the ring [2][v][KT][1028]
__host__ __device__ constexpr size_t smem_floats(int RT, int KT, int D) {
  return padded(D) > kMaxDim
             ? (size_t)(kMaxDim + 4) * (16 * RT + 2 * KT) +
                   (size_t)(kWarps / RT) * 16 * RT * (KT + 4) + 2 * 16 * RT
             : (size_t)(padded(D) + 4) * (16 * RT + 4 * KT) +
                   (size_t)(kWarps / RT) * 16 * RT * (KT + 4) + 2 * 16 * RT;
}

// c[u] += a b[u] in 3xTF32 for every u, in three rounds over u, so the N
// products of a round are independent mma chains
template <int N>
__device__ __forceinline__ void mma3_rounds(float (&c)[N][4], const uint32_t (&ab)[4],
                                            const uint32_t (&as)[4], const uint32_t (&bb)[N][2],
                                            const uint32_t (&bs)[N][2]) {
#pragma unroll
  for (int u = 0; u < N; ++u) mma(c[u], ab, bs[u]);
#pragma unroll
  for (int u = 0; u < N; ++u) mma(c[u], as, bb[u]);
#pragma unroll
  for (int u = 0; u < N; ++u) mma(c[u], ab, bb[u]);
}

template <int RT, int KT, bool GROUPS>
__global__ void __launch_bounds__(kThreads)
    attention_fwd_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, float* __restrict__ out, int L,
                              int D, float scale, bool vec) {
  constexpr int BR = 16 * RT;     // query rows of the block
  constexpr int WR = kWarps / RT;  // warps of a row tile: D chunks, then column slabs
  constexpr int KG = KT / 8;       // key groups of a tile
  constexpr int PS = KT + 4;       // row stride of the score blocks
  constexpr int G = kThreads / BR < KT ? kThreads / BR : KT;  // softmax threads a row
  constexpr int KPT = KT / G;      // keys of a softmax thread
  extern __shared__ __align__(16) float smem[];
  const int DP = padded(D), NK = DP / 8;
  // this block's output columns [c0, c0 + CW), DG of them data
  const int c0 = GROUPS ? (int)blockIdx.y * kMaxDim : 0;
  const int CW = GROUPS ? min(DP - c0, kMaxDim) : DP, DG = min(D - c0, CW);
  const int ST = CW + 4;
  float* qs = smem;                     // [BR][ST]: q (not GROUPS), at the end out
  float* ring = qs + BR * ST;           // [2][k (not GROUPS), v][KT][ST]
  constexpr int kRows = GROUPS ? 2 : 4;  // staged rows of a ring stage, in KT
  float* sc = ring + kRows * KT * ST;   // [WR][BR][PS]: partial scores; [0] then p
  float* alpha_s = sc + WR * BR * PS;   // [BR]
  float* l_s = alpha_s + BR;            // [BR]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // a slice's row blocks are neighbours in launch order, so they run
  // together and read its keys and values from L2
  const int row_blocks = (L + BR - 1) / BR;
  const int slice = blockIdx.x / row_blocks;
  const int row0 = (blockIdx.x - slice * row_blocks) * BR;
  const size_t base = (size_t)slice * L * D;
  const int rt = warp % RT, wc = warp / RT;
  const int qr = rt * 16 + g;                  // this lane's rows qr and qr + 8
  const int per = (NK + WR - 1) / WR;          // k-steps of a chunk
  const int d0 = min(wc * per, NK), d1 = min(d0 + per, NK);
  const int pv = (CW / 8 + WR - 1) / WR;       // n-tiles of a slab (of the group)
  const int e0 = min(wc * pv, CW / 8), e1 = min(e0 + pv, CW / 8);
  const int n_tiles = (L + KT - 1) / KT;

  // q's rows, prescaled; zero past L and D
  const int W = vec ? CW / 4 : CW;
  for (int i = tid; i < (GROUPS ? 0 : BR * W); i += kThreads) {
    const int r = i / W, c = (i - r * W) * (vec ? 4 : 1);
    const bool in = row0 + r < L && c < D;
    const float* from = q + base + (size_t)(row0 + r) * D + c;
    float* to = qs + r * ST + c;
    if (vec) {
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (in) x = *reinterpret_cast<const float4*>(from);
      *reinterpret_cast<float4*>(to) = make_float4(x.x * scale, x.y * scale, x.z * scale,
                                                   x.w * scale);
    } else {
      *to = in ? *from * scale : 0.f;
    }
  }
  // the ring's columns past D are never copied: zero them once
  if (DG != CW)
    for (int i = tid; i < kRows * KT * (CW - DG); i += kThreads) {
      const int r = i / (CW - DG);
      ring[r * ST + DG + i - r * (CW - DG)] = 0.f;
    }
  // tile j's k and v rows (GROUPS: v's, the group's columns) into ring
  // stage j & 1; rows past L zero-filled
  auto stage = [&](int tile) {
    const int j0 = tile * KT, count = min(KT, L - j0);
    float* dst = ring + (tile & 1) * (kRows / 2) * KT * ST;
    const int Wd = vec ? DG / 4 : DG;
    for (int i = tid; i < (kRows / 2) * KT * Wd; i += kThreads) {
      const int r = i / Wd, c = (i - r * Wd) * (vec ? 4 : 1);  // k rows, then v rows
      const bool is_k = !GROUPS && r < KT;
      const int key = r < KT ? r : r - KT;
      float* to = dst + r * ST + c;
      if (key < count) {
        const float* from = (is_k ? k : v) + base + (size_t)(j0 + key) * D + c0 + c;
        if (vec)
          __pipeline_memcpy_async(to, from, 16);
        else
          __pipeline_memcpy_async(to, from, 4);
      } else if (vec) {
        *reinterpret_cast<float4*>(to) = make_float4(0.f, 0.f, 0.f, 0.f);
      } else {
        *to = 0.f;
      }
    }
  };

  // the softmax thread's row and keys, and its running maximum and share
  // of the running sum
  const int sr = tid / G, sk = (tid % G) * KPT;
  const bool soft = tid < BR * G;  // whole warps
  float m_run = -INFINITY, l_run = 0.f;
  float o[kMaxTiles][4];
#pragma unroll
  for (int i = 0; i < kMaxTiles; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;

  stage(0);
  __pipeline_commit();
  for (int tile = 0; tile < n_tiles; ++tile) {
    __pipeline_wait_prior(0);
    __syncthreads();  // the tile has landed; every warp is done with the last one
    if (tile + 1 < n_tiles) stage(tile + 1);
    __pipeline_commit();
    const float* ks_ = ring + (tile & 1) * (kRows / 2) * KT * ST;
    const float* vs_ = GROUPS ? ks_ : ks_ + KT * ST;
    const int n_keys = min(KT, L - tile * KT);

    // partial scores of the row tile over this warp's chunk of D.  A
    // fragment a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4);
    // B fragment b0 (key g, dim t), b1 (key g, dim t + 4)
    {
      float c[KG][4];
#pragma unroll
      for (int kg = 0; kg < KG; ++kg)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[kg][e] = 0.f;
      for (int ks = d0; ks < d1; ++ks) {
        uint32_t ab[4], as[4];
        uint32_t bb[KG][2], bs[KG][2];
        if (GROUPS) {  // from L2: zero past L and D, q scaled as the staging scales it
          const int col = ks * 8 + t, r0 = row0 + qr;
          auto qv = [&](int r, int cc) {
            return r < L && cc < D ? q[base + (size_t)r * D + cc] * scale : 0.f;
          };
          split<true>(qv(r0, col), ab[0], as[0]);
          split<true>(qv(r0 + 8, col), ab[1], as[1]);
          split<true>(qv(r0, col + 4), ab[2], as[2]);
          split<true>(qv(r0 + 8, col + 4), ab[3], as[3]);
#pragma unroll
          for (int kg = 0; kg < KG; ++kg) {
            const int key = tile * KT + kg * 8 + g;
            const float* kb = k + base + (size_t)key * D + col;
            const bool in = key < L;
            split_b<false>(in && col < D ? kb[0] : 0.f, in && col + 4 < D ? kb[4] : 0.f,
                           bb[kg], bs[kg]);
          }
        } else {
          const float* qa = qs + qr * ST + ks * 8 + t;
          split<true>(qa[0], ab[0], as[0]);
          split<true>(qa[8 * ST], ab[1], as[1]);
          split<true>(qa[4], ab[2], as[2]);
          split<true>(qa[8 * ST + 4], ab[3], as[3]);
#pragma unroll
          for (int kg = 0; kg < KG; ++kg) {
            const float* kb = ks_ + (kg * 8 + g) * ST + ks * 8 + t;
            split_b<false>(kb[0], kb[4], bb[kg], bs[kg]);
          }
        }
        mma3_rounds<KG>(c, ab, as, bb, bs);
      }
      // C fragment: c0, c1 (row g, keys 2t, 2t + 1), c2, c3 (row g + 8)
      float* to = sc + (wc * BR + qr) * PS + 2 * t;
#pragma unroll
      for (int kg = 0; kg < KG; ++kg) {
        *reinterpret_cast<float2*>(to + kg * 8) = make_float2(c[kg][0], c[kg][1]);
        *reinterpret_cast<float2*>(to + 8 * PS + kg * 8) = make_float2(c[kg][2], c[kg][3]);
      }
    }
    __syncthreads();  // the partial scores are written

    if (soft) {
      float s[KPT];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float* p = sc + sr * PS + sk + j;
        float a = p[0];
#pragma unroll
        for (int w = 1; w < WR; ++w) a += p[w * BR * PS];
        s[j] = sk + j < n_keys ? a : -INFINITY;  // keys past L
        mx = fmaxf(mx, s[j]);
      }
#pragma unroll
      for (int x = 1; x < G; x <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, x));
      const float m_new = fmaxf(m_run, mx);
      const float alpha = ex2(m_run - m_new);  // 0 on the first tile
      m_run = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const float p = ex2(s[j] - m_new);
        sc[sr * PS + sk + j] = p;
        sum += p;
      }
      l_run = l_run * alpha + sum;
      if (sk == 0) alpha_s[sr] = alpha;
    }
    __syncthreads();  // p and the rescales are written

    // p v on this warp's column slab: A fragment (k index t <-> key 2t,
    // t + 4 <-> key 2t + 1); B fragment b0 (key 2t, column g), b1 (key
    // 2t + 1, column g)
    {
      const float a0 = alpha_s[qr], a1 = alpha_s[qr + 8];
#pragma unroll
      for (int i = 0; i < kMaxTiles; ++i) {
        o[i][0] *= a0;
        o[i][1] *= a0;
        o[i][2] *= a1;
        o[i][3] *= a1;
      }
#pragma unroll
      for (int kg = 0; kg < KG; ++kg) {
        const float2 p0 = *reinterpret_cast<const float2*>(sc + qr * PS + kg * 8 + 2 * t);
        const float2 p1 = *reinterpret_cast<const float2*>(sc + (qr + 8) * PS + kg * 8 + 2 * t);
        uint32_t pb[4], ps[4];
        split<false>(p0.x, pb[0], ps[0]);
        split<false>(p1.x, pb[1], ps[1]);
        split<false>(p0.y, pb[2], ps[2]);
        split<false>(p1.y, pb[3], ps[3]);
        const float* vr = vs_ + (kg * 8 + 2 * t) * ST + (e0 * 8 + g);
#pragma unroll
        for (int i0 = 0; i0 < kMaxTiles; i0 += 4) {
          const int n = min(4, e1 - e0 - i0);
          if (n <= 0) break;
          uint32_t bb[4][2], bs[4][2];
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (u < n) split_b<true>(vr[(i0 + u) * 8], vr[ST + (i0 + u) * 8], bb[u], bs[u]);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (u < n) mma(o[i0 + u], pb, bs[u]);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (u < n) mma(o[i0 + u], ps, bb[u]);
#pragma unroll
          for (int u = 0; u < 4; ++u)
            if (u < n) mma(o[i0 + u], pb, bb[u]);
        }
      }
    }
  }

  if (soft) {
#pragma unroll
    for (int x = 1; x < G; x <<= 1) l_run += __shfl_xor_sync(0xffffffffu, l_run, x);
    if (sk == 0) l_s[sr] = l_run;
  }
  __syncthreads();  // the sums are written; q's rows are free for the output
  {
    const float l0 = l_s[qr], l1 = l_s[qr + 8];
#pragma unroll
    for (int i = 0; i < kMaxTiles; ++i) {
      if (e0 + i < e1) {
        float* to = qs + qr * ST + (e0 + i) * 8 + 2 * t;
        *reinterpret_cast<float2*>(to) = make_float2(o[i][0] / l0, o[i][1] / l0);
        *reinterpret_cast<float2*>(to + 8 * ST) = make_float2(o[i][2] / l1, o[i][3] / l1);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < BR * W; i += kThreads) {
    const int r = i / W, c = (i - r * W) * (vec ? 4 : 1);
    if (row0 + r >= L || c >= DG) continue;
    float* to = out + base + (size_t)(row0 + r) * D + c0 + c;
    if (vec)
      *reinterpret_cast<float4*>(to) = *reinterpret_cast<const float4*>(qs + r * ST + c);
    else
      *to = qs[r * ST + c];
  }
}

template <int RT, int KT, bool GROUPS>
cudaError_t launch(const float* q, const float* k, const float* v, float* out, int BH, int L,
                   int D, bool vec, cudaStream_t st) {
  const size_t smem = sizeof(float) * smem_floats(RT, KT, D);
  if (smem > kSmemLimit) return cudaErrorInvalidValue;
  const long long blocks = (long long)BH * ((L + 16 * RT - 1) / (16 * RT));
  const long long groups = (padded(D) + kMaxDim - 1) / kMaxDim;
  if (blocks > 0x7fffffffLL || groups > 65535) return cudaErrorInvalidValue;
  auto kernel = attention_fwd_wide_kernel<RT, KT, GROUPS>;
  static size_t opted_in = 48 * 1024;  // above 48 KB a block needs the opt-in
  if (smem > opted_in) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  const float scale = 1.4426950408889634f / sqrtf(static_cast<float>(D));  // log2(e) / sqrt(D)
  kernel<<<dim3((unsigned)blocks, (unsigned)groups), kThreads, smem, st>>>(q, k, v, out, L, D,
                                                                           scale, vec);
  return cudaGetLastError();
}

}  // namespace

// out (BH, L, D) from contiguous float32 q, k, v (BH, L, D), D > 128, with
// ops/cuda/attention.py's wide_tiling() (RT, KT): RT row tiles of 16 query
// rows a block, KT keys a staged tile; grid BH ceil(L / (16 RT)) x
// ceil(DP / 1024) column groups (one group up to DP = 1024; past it (1, 8)
// only).  vec: D is a multiple of 4 and every pointer 16-byte aligned.
// Returns cudaGetLastError() after the launch.
extern "C" int nf_attention_fwd_wide(const void* q, const void* k, const void* v, void* out,
                                     int BH, int L, int D, int RT, int KT, int vec,
                                     void* stream) {
  if (BH <= 0) return 0;
  const bool groups = padded(D) > kMaxDim;
  if (L <= 0 || D <= 128 || RT <= 0 || (!groups && padded(D) * RT > kMaxDim) ||
      (groups && (RT != 1 || KT != 8)) || (vec && D % 4 != 0))
    return (int)cudaErrorInvalidValue;
  const auto* qf = static_cast<const float*>(q);
  const auto* kf = static_cast<const float*>(k);
  const auto* vf = static_cast<const float*>(v);
  auto* of = static_cast<float*>(out);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (groups) return (int)launch<1, 8, true>(qf, kf, vf, of, BH, L, D, vec != 0, st);
  if (RT == 4 && KT == 32) return (int)launch<4, 32, false>(qf, kf, vf, of, BH, L, D, vec != 0, st);
  if (RT == 2 && KT == 16) return (int)launch<2, 16, false>(qf, kf, vf, of, BH, L, D, vec != 0, st);
  if (RT == 1 && KT == 8) return (int)launch<1, 8, false>(qf, kf, vf, of, BH, L, D, vec != 0, st);
  return (int)cudaErrorInvalidValue;
}
