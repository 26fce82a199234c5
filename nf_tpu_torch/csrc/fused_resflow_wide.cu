// The ResFlow 1-D density stack past the tiled kernels' widths (F > 256 or
// D > 8), Hopper (sm_90a): thread block clusters, tensor cores in 3xTF32.
//
// Replaces, for every F and D that nf_tpu's extract_resflow_spec matches,
// the three Pallas kernels of nf_tpu/ops/pallas/fused_resflow.py, one
// template variant each (SOLVE, LOGDET):
//   solve     (true,  false)  make_solve_kernel        (call_solve)
//   solve_ld  (true,  true)   make_solve_logdet_kernel (call_solve_logdet)
//   fwd_ld    (false, true)   make_fwd_logdet_kernel   (call_fwd_logdet)
// csrc/fused_resflow.cu runs F <= 256 and D <= 8.  The walk is the same:
// over n x [ ActNorm(D) -> InvertibleResBlock(g) ], with
//   g(x) = W3t h2 + b3,  h2 = LipSwish_b(W2t h1 + b2),  h1 = LipSwish_a(W1t x + b1);
// forward x = (x - an_b) e^{-an_s}, z = x + g(x); inverse the fixed point
// x <- z - g(x) from x0 = z - g(z), stopping only where max |x - prev| <
// ftol over the cluster's samples or at n_iters, then x e^{an_s} + an_b,
// the walk reversed.  LOGDET adds per block the 'unbias' series of the 4
// probes at the block's input x: ser_s = sum_{k <= n_terms[s]} coef[k]
// v_s^T J^k v_s, coef[k] = (-1)^(k+1) 2^max(0, k - n_exact - 1) / k (nf_tpu's
// roulette_coefficient), each probe's terms summed in k order, acc +=
// (ser_0 + ser_1 + ser_2 + ser_3) / 4 in probe order, and ld = ld_sign acc +
// ld_const (ActNorm's constant, from the host).
//
// J^k, not (J^T)^k: v^T (J^T)^k v = v^T J^k v (a scalar is its own
// transpose), and J = W3t D2 W2t D1 W1t multiplies by the same three
// matrices as g itself: J w = W3t (d2 * (W2t (d1 * (W1t w)))), with the
// LipSwish' masks d1, d2 at the block's input.  So every product of a
// residual block, the fixed point's and the series', is the same chain
//   stage A  a = W1t in        (F x D: all F rows, the D-wide product)
//   stage B  c = W2t a         (F x F: the repeated matrix)
//   stage C  out = W3t c       (D x F)
// with LipSwish (g) or the masks (the series) between the stages, and one
// F x F matrix, W2t, is the one the walk repeats.
//
// Bound (H100 SXM, NVIDIA's peaks): per sample and block a g evaluation
// and a J product are each D F + F^2 + F D multiply-adds; at the port's probes the forward does
// 1 evaluation and 42 products, the inverse the fixed point's 4-6 more.  At
// (D, F) = (2, 512), B = 1000, 2 blocks that is 4.4e10 flop a direction:
// operations bound it (0.68 ms at the 67 TFLOP/s FFMA rate, 0.28 ms on the
// tensor cores in 3xTF32), far above the weights' 2 MB and the data's bytes.
//
// Design.
//  * A thread block cluster of C blocks (C in {1, 2, 4, 8}, at run time)
//    owns S samples (a multiple of 8).  Member m holds rows [m Fs, (m + 1)
//    Fs) of W2t, Fs = FP / C, and computes stage B for those rows only, and
//    stage C over them: a D-wide partial sum.  Stage A (D-wide) every member
//    computes whole for itself.  The members' partials cross through
//    distributed shared memory after one cluster barrier per product, each
//    member adding them in member order 0 .. C-1: every member then holds
//    the same g (or J w), bit for bit, so each tests the fixed point's stop
//    by itself and all stop together.  Double-buffered partials need no
//    second barrier.
//  * W2t, the matrix the walk repeats, stays resident where it fits: each
//    member stages its slab into shared memory once per residual block
//    (bulk copies, one mbarrier) and walks every product of the block from
//    there; else its fragments come from L2 through the read-only path at
//    every product.  W1t and the member's W3t columns are staged too where
//    they fit.  The plan (fused_resflow.py::wide_plan) picks C, S and what
//    is resident: measured on an NVIDIA H100 80GB HBM3 at 700.00 W
//    (resflow_wide_probe.py), small clusters win, 1 member up to F = 256
//    (all of W2t resident at (16, 64)) and 2 reading their slabs from L2
//    past it ((2, 512): 1.42 ms fwd_ld against 3.31 for 8 members holding
//    theirs), since every member repeats stage A and clusters of 8 fill the
//    card only 15 at a time.
//  * The probes run side by side: a series term is one product chain over
//    L S columns, the L probes still live (the host sorts them by series
//    length, longest first, so the live ones are a prefix; Params::order).
//    A probe whose series has ended drops out; each keeps its own k order.
//  * Stage B (W2t) and stage C (W3t) are mma.sync.m16n8k8 TF32 in the
//    3xTF32 split of tf32_split.cuh (A, the weights, rounded as its
//    fragments load from f32; B, the columns, truncated).  The weights are
//    in A-fragment order (fused_resflow.py::wide_fragments), the columns
//    in B-fragment order (bfrag_index): a 16-byte load a lane for A and one
//    for each pair of n-tiles.  Stage A (W1t, D-wide) runs on the FFMA
//    units, a thread a fragment slot.  D is padded to 16 for stage C's M,
//    F to a multiple of 16 C.
//  * Stage A runs in k-chunks of Kc rows into a double buffer while stage B
//    accumulates the previous chunk in registers (a warp's unit: an m-tile
//    of the slab and 4 n-tiles, 8 where W2t comes from L2; the k-steps split
//    over warps where units are fewer than warps), so the hidden vector
//    never needs all F rows at once; columns go in chunks of Nc.
//  * An instance per residence (VS: vectors in shared memory, WS: W2t's
//    slab, W1t and W3t staged): with every operand behind a runtime select
//    the compiler emitted 64-bit generic loads for shared memory, 2x slower
//    at (2, 512).
//  * Where the vectors do not fit beside the slab (F past ~1,500 at 16
//    samples) they go to device scratch the wrapper allocates, the same code
//    through generic pointers.
//  * Accurate expf and IEEE division (the series kernels' LipSwish).

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "bulk_ring.cuh"
#include "tf32_split.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kProbes = 4;
constexpr int kNExact = 8;        // the serving estimator's n_exact
constexpr int kMaxTerms = kNExact + 32;
constexpr int kWarps = 16;        // warps per block (one cluster member)
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxCluster = 8;
constexpr int kCopyPiece = 32768; // bytes per bulk copy
constexpr size_t kSmemLimit = 232448;  // dynamic shared memory of one block

__host__ __device__ inline int round_up(int x, int m) { return (x + m - 1) / m * m; }
__host__ __device__ inline int r4(int x) { return (x + 3) & ~3; }

// Where everything lives, in floats; fused_resflow.py::wide_geometry mirrors it.
// The weight block of one residual block (wide_weights):
//   b1 [FP], b2 [FP], b3 [DP16], an_s [DP16], an_b [DP16], beta [2] (to a multiple of 4)
//   w1 [FP][D]                 W1t, row-major (stage A runs on the FFMA units)
//   w2 [FP/16][FP/8][32][4]    W2t (FP x FP) in A-fragment order, m-tile major:
//                              member m's slab is contiguous
//   w3 [FP/8][DP16/16][32][4]  W3t (DP16 x FP), k-step major: member m's columns contiguous
// Shared memory: an mbarrier (4 floats), the resident weights (w2 slab Fs x FP,
// w1 FP x D, w3 DP16 x Fs), the partials [2][D][cols] where part_smem, the
// vectors where vec_smem; device scratch per block: the rest.  Vectors:
//   X [D][S] x, Z [D][S], G [D][S], W [D][cols] the series' iterates J^k v,
//   V [D][cols] the probes, d1 [FP][S], d2 [Fs][S] the masks,
//   a [nbuf][Kc x Nc] stage A's chunks, c [Fs x Nc] stage B's output, both
//   in the B-fragment order (bfrag_index),
//   ser [4][S], acc [S];
// columns of a series term: q S + s for the q-th longest probe and sample s.
struct WideGeom {
  int F, D, C, S, Nc, Kc;
  int FP, Fs, DP16, MTs, KS, MT16, cols, nbuf;
  bool w2_res, w1_res, w3_res, vec_smem, part_smem;
  int o_b1, o_b2, o_b3, o_ans, o_anb, o_beta, o_w1, o_w2, o_w3, size;
  int s_w2, s_w1, s_w3, staged, part_at, vec_at;
  int v_X, v_Z, v_G, v_W, v_V, v_d1, v_d2, v_a, v_c, v_ser, v_acc, vec_floats;
  int smem_floats, scratch_floats;

  __host__ __device__ WideGeom(int F_, int D_, const int* plan)
      : F(F_), D(D_), C(plan[0]), S(plan[1]), Nc(plan[2]), Kc(plan[3]) {
    w2_res = plan[4] != 0;
    w1_res = plan[5] != 0;
    w3_res = plan[6] != 0;
    vec_smem = plan[7] != 0;
    part_smem = plan[8] != 0;
    FP = round_up(F, 16 * C);
    Fs = FP / C;
    DP16 = round_up(D, 16);
    MTs = Fs / 16;
    KS = FP / 8;
    MT16 = DP16 / 16;
    cols = kProbes * S;
    nbuf = Kc < FP ? 2 : 1;
    o_b1 = 0;
    o_b2 = o_b1 + FP;
    o_b3 = o_b2 + FP;
    o_ans = o_b3 + DP16;
    o_anb = o_ans + DP16;
    o_beta = o_anb + DP16;
    o_w1 = r4(o_beta + 2);
    o_w2 = o_w1 + r4(FP * D);
    o_w3 = o_w2 + FP * FP;
    size = o_w3 + DP16 * FP;
    int at = 4;  // the mbarrier
    s_w2 = at;
    at += w2_res ? Fs * FP : 0;
    s_w1 = at;
    at += w1_res ? r4(FP * D) : 0;
    s_w3 = at;
    at += w3_res ? DP16 * Fs : 0;
    staged = at - 4;
    int sc = 0;  // scratch floats per block
    const int part = r4(2 * D * cols);
    if (part_smem) {
      part_at = at;
      at += part;
    } else {
      part_at = sc;
      sc += part;
    }
    int v = 0;
    v_X = v;  v += r4(D * S);
    v_Z = v;  v += r4(D * S);
    v_G = v;  v += r4(D * S);
    v_W = v;  v += r4(D * cols);
    v_V = v;  v += r4(D * cols);
    v_d1 = v; v += r4(FP * S);
    v_d2 = v; v += r4(Fs * S);
    v_a = v;  v += nbuf * Kc * Nc;
    v_c = v;  v += Fs * Nc;
    v_ser = v; v += r4(kProbes * S);
    v_acc = v; v += r4(S);
    vec_floats = v;
    if (vec_smem) {
      vec_at = at;
      at += v;
    } else {
      vec_at = sc;
      sc += v;
    }
    smem_floats = at;
    scratch_floats = sc;
  }

  // whether the plan is one the kernel takes
  __host__ bool valid() const {
    return F >= 1 && D >= 1 && (C == 1 || C == 2 || C == 4 || C == 8) && S >= 8 && S % 8 == 0 &&
           Nc >= 32 && Nc % 32 == 0 && Kc >= 16 && Kc % 16 == 0 && Kc <= FP &&
           (C == 1 || part_smem) && (size_t)smem_floats * 4 <= kSmemLimit;
  }
};

struct WideParams {
  WideGeom geo;        // the plan's geometry, from the host (read from the constant bank)
  const float* x;      // (B, D) input
  float* y;            // (B, D) output
  float* ld;           // (B,) log-det (LOGDET)
  const float* w;      // (n, WideGeom::size) per-block weight blocks
  const float* v;      // (4, B, D) probes (LOGDET)
  float* scratch;      // (blocks, scratch_floats) device scratch, or nullptr
  int plan[9];         // C, S, Nc, Kc, w2_res, w1_res, w3_res, vec_smem, part_smem
  int order[kProbes];  // probes by series length, longest first (ties by index)
  int n_sorted[kProbes];     // their lengths
  float coef[kMaxTerms + 1];  // term k's weight
  int B, n, D, F, n_iters;
  float ftol, ld_sign, ld_const;
};

__device__ __forceinline__ float sigmoid(float a) { return 1.f / (1.f + expf(-a)); }

// LipSwish and its derivative at the pre-activation a
__device__ __forceinline__ void lipswish(float a, float beta, float& h, float& d) {
  const float s = sigmoid(beta * a);
  h = a * s / 1.1f;
  d = (s + beta * a * s * (1.f - s)) / 1.1f;
}

// acc[j] (the 16 x 8 C fragments of NJ n-tiles, NJ / 2 pairs) += A B over
// the k-steps k0, k0 + kstep, ... < KS: A's fragments at a + ks a_ks (this
// m-tile, 128 floats a k-step), B's in the B-fragment order (bfrag_index) at
// b + ks b_ks, a pair of n-tiles 128 floats on: one 16-byte load a lane for
// A and one for each pair.  3xTF32: A rounded, B truncated; the big
// products and the two small ones in separate accumulators (two short
// dependency chains, not one of three mma), added at the end; each k-step's
// fragments load while the last one multiplies (AG: A from device memory,
// through the read-only path).  Every n-tile is
// multiplied (no per-tile guard, which would cost a warp sync an mma); the
// caller drops the columns it does not own.
template <int NJ, bool AG = false>
__device__ __forceinline__ void mma_tile(float (&acc)[NJ][4], const float* a, int a_ks, int KS,
                                         const float* b, int b_ks, int k0 = 0, int kstep = 1) {
  constexpr int NPR = NJ / 2;
  constexpr bool LO = NJ <= 4;  // 8 n-tiles are chains enough, and registers run out
  const int lane = threadIdx.x & 31;
  a += 4 * lane;
  b += 4 * lane;
  float lo[NJ][4];
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) lo[j][r] = 0.f;
  float4 an = make_float4(0.f, 0.f, 0.f, 0.f), bn[NPR];
#pragma unroll
  for (int p = 0; p < NPR; ++p) bn[p] = an;
  auto fetch = [&](int ks) {
    an = AG ? __ldg(reinterpret_cast<const float4*>(a + ks * a_ks))
            : *reinterpret_cast<const float4*>(a + ks * a_ks);
#pragma unroll
    for (int p = 0; p < NPR; ++p) bn[p] = *reinterpret_cast<const float4*>(b + ks * b_ks + 128 * p);
  };
  if (k0 < KS) fetch(k0);
  for (int ks = k0; ks < KS; ks += kstep) {
    const float4 av = an;
    float4 bv[NPR];
#pragma unroll
    for (int p = 0; p < NPR; ++p) bv[p] = bn[p];
    if (ks + kstep < KS) fetch(ks + kstep);
    uint32_t ab[4], as[4];
    split<true>(av.x, ab[0], as[0]);
    split<true>(av.y, ab[1], as[1]);
    split<true>(av.z, ab[2], as[2]);
    split<true>(av.w, ab[3], as[3]);
#pragma unroll
    for (int p = 0; p < NPR; ++p) {
      uint32_t bb[2], bs[2];
      split_b<false>(bv[p].x, bv[p].y, bb, bs);
      mma(LO ? lo[2 * p] : acc[2 * p], ab, bs);
      mma(LO ? lo[2 * p] : acc[2 * p], as, bb);
      mma(acc[2 * p], ab, bb);
      split_b<false>(bv[p].z, bv[p].w, bb, bs);
      mma(LO ? lo[2 * p + 1] : acc[2 * p + 1], ab, bs);
      mma(LO ? lo[2 * p + 1] : acc[2 * p + 1], as, bb);
      mma(acc[2 * p + 1], ab, bb);
    }
  }
  if (LO)
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[j][r] += lo[j][r];
}

// where element (k, n) of a B operand sits in the B-fragment order
// [k / 8][n / 16][lane][4] of a buffer npr pairs of n-tiles wide: lane 4 (n % 8)
// + k % 4, float 2 ((n / 8) % 2) + (k % 8) / 4 (b0, b1 of one n-tile, then
// of the next)
__device__ __forceinline__ int bfrag_index(int k, int n, int npr) {
  return (((k >> 3) * npr + (n >> 4)) * 32 + 4 * (n & 7) + (k & 3)) * 4 + 2 * ((n >> 3) & 1) +
         ((k >> 2) & 1);
}

// VS: the vectors and the partials in shared memory, WS: W2t's slab, W1t
// and W3t staged (the pointers then derive from `smem` alone, and the
// compiler emits shared loads with 32-bit addresses); else through generic
// pointers, W2t from device memory through the read-only path
template <bool SOLVE, bool LOGDET, bool VS, bool WS>
__global__ void __launch_bounds__(kThreads, 1)
    fused_resflow_wide_kernel(const __grid_constant__ WideParams prm) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const WideGeom& geo = prm.geo;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int C = geo.C, m = (int)cluster.block_rank();
  const int D = geo.D, S = geo.S, FP = geo.FP, Fs = geo.Fs, cols = geo.cols;
  const int npr = geo.Nc / 16;  // pairs of n-tiles in a row of abuf / cbuf
  const int sample0 = (int)(blockIdx.x / C) * S;
  auto valid = [&](int s) { return sample0 + s < prm.B; };
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  float* scratch = prm.scratch != nullptr ? prm.scratch + (size_t)blockIdx.x * geo.scratch_floats
                                          : nullptr;
  float* part = (VS || geo.part_smem ? smem : scratch) + geo.part_at;  // [2][D][cols]
  float* vb = (VS || geo.vec_smem ? smem : scratch) + geo.vec_at;
  float* X = vb + geo.v_X;
  float* Z = vb + geo.v_Z;
  float* G = vb + geo.v_G;
  float* Wv = vb + geo.v_W;
  float* V = vb + geo.v_V;
  float* d1 = vb + geo.v_d1;
  float* d2 = vb + geo.v_d2;
  float* abuf = vb + geo.v_a;
  float* cbuf = vb + geo.v_c;
  float* ser = vb + geo.v_ser;
  float* acc = vb + geo.v_acc;

  for (int i = tid; i < geo.vec_floats; i += kThreads) vb[i] = 0.f;
  if (tid == 0 && geo.staged > 0) {
    bar_init(bar, 1);
    bar_init_fence();
  }
  __syncthreads();
  for (int i = tid; i < D * S; i += kThreads) {
    const int d = i / S, s = i - d * S;
    X[i] = valid(s) ? prm.x[(size_t)(sample0 + s) * D + d] : 0.f;
  }
  if (LOGDET)
    for (int i = tid; i < D * cols; i += kThreads) {
      const int d = i / cols, col = i - d * cols, q = col / S, s = col - q * S;
      V[i] = valid(s) ? prm.v[((size_t)prm.order[q] * prm.B + sample0 + s) * D + d] : 0.f;
    }
  if (C > 1) cluster.sync();  // every member has started: its shared memory may be read
  else __syncthreads();

  uint32_t phase = 0;
  int pbuf = 0;  // the partials' buffer of the next product
  for (int step = 0; step < prm.n; ++step) {
    const float* wb = prm.w + (size_t)(SOLVE ? prm.n - 1 - step : step) * geo.size;
    if (geo.staged > 0) {
      __syncthreads();  // every warp is done with the last block's weights
      if (tid == 0) {
        bar_expect(bar, (uint32_t)(4 * geo.staged));
        auto copy = [&](float* dst, const float* src, int floats) {
          for (int o = 0; o < 4 * floats; o += kCopyPiece)
            bulk_load(reinterpret_cast<char*>(dst) + o, reinterpret_cast<const char*>(src) + o,
                      (uint32_t)min(kCopyPiece, 4 * floats - o), bar);
        };
        if (geo.w2_res) copy(smem + geo.s_w2, wb + geo.o_w2 + (size_t)m * Fs * FP, Fs * FP);
        if (geo.w1_res) copy(smem + geo.s_w1, wb + geo.o_w1, r4(FP * D));
        if (geo.w3_res)
          copy(smem + geo.s_w3, wb + geo.o_w3 + (size_t)m * Fs * geo.DP16, geo.DP16 * Fs);
      }
      bar_wait(bar, phase);
      phase ^= 1;
    }
    const float* W1 = WS || geo.w1_res ? smem + geo.s_w1 : wb + geo.o_w1;
    const float* W2 = WS ? smem + geo.s_w2 : wb + geo.o_w2 + (size_t)m * Fs * FP;
    const float* W3 =
        WS || geo.w3_res ? smem + geo.s_w3 : wb + geo.o_w3 + (size_t)m * Fs * geo.DP16;
    const float* b1 = wb + geo.o_b1;
    const float* b2 = wb + geo.o_b2 + m * Fs;
    const float* b3 = wb + geo.o_b3;
    const float* an_s = wb + geo.o_ans;
    const float* an_b = wb + geo.o_anb;
    const float beta_a = wb[geo.o_beta], beta_b = wb[geo.o_beta + 1];

    // One product chain over columns [0, ncols) of `in` ([D][ld_in]):
    // g's (SER false: LipSwish after stages A and B, the masks d1, d2 kept
    // with MASKS, stage C with NEED_C) or a series term's (SER: the masks).
    // Stage C leaves this member's partials in part[pbuf].
    auto chain = [&](auto ser_t, const float* in, int ld_in, int ncols, bool masks,
                     bool need_c) {
      constexpr bool SER = decltype(ser_t)::value;
      const int nk = (FP + geo.Kc - 1) / geo.Kc;
      for (int c0 = 0; c0 < ncols; c0 += geo.Nc) {
        const int cc = min(geo.Nc, ncols - c0), NT = cc >> 3;
        // stage A of k-chunk kc on the FFMA units: rows [kc Kc, ...) of a for
        // these columns, a thread a fragment slot: the 4 elements (k, n),
        // (k + 4, n), (k, n + 8), (k + 4, n + 8) that one lane of stage B
        // loads as one float4 (bfrag_index), stored whole
        auto stage_a = [&](int kc) {
          const int r0 = kc * geo.Kc, prs = (cc + 15) >> 4;
          const int slots = (min(geo.Kc, FP - r0) >> 3) * prs * 32;
          float* ab = abuf + (kc % geo.nbuf) * geo.Kc * geo.Nc;
          for (int sl = tid; sl < slots; sl += kThreads) {
            const int ln = sl & 31, rest = sl >> 5, pr = rest % prs, ks = rest / prs;
            const int k = 8 * ks + (ln & 3), n = 16 * pr + (ln >> 2);
            const int row[2] = {r0 + k, r0 + k + 4}, col[2] = {c0 + n, c0 + n + 8};
            int smp[2] = {col[0] % S, 0};  // the columns' samples (series: q S + s)
            smp[1] = smp[0] + 8 < S ? smp[0] + 8 : smp[0] + 8 - S;
            const float* w0 = W1 + (size_t)row[0] * D;
            const float* w1 = w0 + 4 * D;
            const float* x0 = in + col[0];
            float e[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // [row][col]
#pragma unroll 2
            for (int d = 0; d < D; ++d) {
              const float xa = x0[d * ld_in], xb = x0[d * ld_in + 8], u0 = w0[d], u1 = w1[d];
              e[0][0] = fmaf(u0, xa, e[0][0]);
              e[1][0] = fmaf(u1, xa, e[1][0]);
              e[0][1] = fmaf(u0, xb, e[0][1]);
              e[1][1] = fmaf(u1, xb, e[1][1]);
            }
#pragma unroll
            for (int i = 0; i < 2; ++i)
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                if (SER) {
                  e[i][j] *= d1[row[i] * S + smp[j]];
                } else {
                  float dd;
                  lipswish(e[i][j] + b1[row[i]], beta_a, e[i][j], dd);
                  if (masks && n + 8 * j < cc) d1[row[i] * S + col[j]] = dd;
                }
              }
            *reinterpret_cast<float4*>(ab + ((ks * npr + pr) * 32 + ln) * 4) =
                make_float4(e[0][0], e[1][0], e[0][1], e[1][1]);
          }
        };
        // stage B: a warp's unit is an m-tile of the slab, a group of up to NW
        // n-tiles and every ksplit-th k-step (where the warps outnumber the
        // units and each keeps 8 k-steps or more); the partials of the
        // k-split meet in abuf (free once the k-chunks are done), summed in
        // split order
        auto stage_b = [&](auto nw_t) {
        constexpr int NW = decltype(nw_t)::value;
        const int NG = (NT + NW - 1) / NW, units = geo.MTs * NG;
        int ksplit = 1;
        while (ksplit < 4 && 2 * ksplit * units <= kWarps && 16 * ksplit <= geo.KS &&
               (2 * ksplit - 1) * (kWarps / (2 * ksplit)) * 128 * NW <= geo.nbuf * geo.Kc * geo.Nc)
          ksplit *= 2;
        for (int u0 = 0; u0 < units; u0 += kWarps / ksplit) {
          const int u = u0 + warp % (kWarps / ksplit), kp = warp / (kWarps / ksplit);
          const bool mine = u < units && kp < ksplit;
          const int mt = u % geo.MTs, ng = u / geo.MTs, nj = min(NW, NT - NW * ng);
          float cacc[NW][4];
#pragma unroll
          for (int j = 0; j < NW; ++j)
#pragma unroll
            for (int r = 0; r < 4; ++r) cacc[j][r] = 0.f;
          stage_a(0);
          __syncthreads();
          for (int kc = 0; kc < nk; ++kc) {
            if (kc + 1 < nk) stage_a(kc + 1);
            const float* ab = abuf + (kc % geo.nbuf) * geo.Kc * geo.Nc;
            const int ks0 = kc * geo.Kc / 8, kss = min(geo.Kc, FP - kc * geo.Kc) / 8;
            if (mine)
              mma_tile<NW, !WS>(cacc, W2 + (mt * geo.KS + ks0) * 128, 128, kss,
                                 ab + 64 * NW * ng, npr * 128, kp, ksplit);
            __syncthreads();
          }
          if (ksplit > 1) {
            // partial kp of unit u: [kp - 1][u - u0][j][lane][4]
            float* pp = abuf + (size_t)((kp - 1) * (kWarps / ksplit) + (u - u0)) * 128 * NW +
                        4 * lane;
            if (mine && kp > 0)
#pragma unroll
              for (int j = 0; j < NW; ++j)
                if (j < nj)
                  *reinterpret_cast<float4*>(pp + 128 * j) =
                      make_float4(cacc[j][0], cacc[j][1], cacc[j][2], cacc[j][3]);
            __syncthreads();
            if (mine && kp == 0)
              for (int q = 1; q < ksplit; ++q) {
                const float* pq = abuf + (size_t)((q - 1) * (kWarps / ksplit) + (u - u0)) *
                                      128 * NW + 4 * lane;
#pragma unroll
                for (int j = 0; j < NW; ++j)
                  if (j < nj) {
                    const float4 v = *reinterpret_cast<const float4*>(pq + 128 * j);
                    cacc[j][0] += v.x;
                    cacc[j][1] += v.y;
                    cacc[j][2] += v.z;
                    cacc[j][3] += v.w;
                  }
              }
          }
          if (mine && kp == 0) {
#pragma unroll
            for (int j = 0; j < NW; ++j) {
              if (j >= nj) continue;
              // the n-tile's first sample (S is a multiple of 8)
              const int s8 = (c0 + 8 * NW * ng + 8 * j) % S;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int o = 16 * mt + g + 8 * h;
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int c = 8 * NW * ng + 8 * j + 2 * t + e, col = c0 + c;
                  const float val = cacc[j][2 * h + e];
                  if (SER) {
                    cbuf[bfrag_index(o, c, npr)] = val * d2[o * S + s8 + 2 * t + e];
                  } else {
                    float hh, dd;
                    lipswish(val + b2[o], beta_b, hh, dd);
                    if (need_c) cbuf[bfrag_index(o, c, npr)] = hh;
                    if (masks) d2[o * S + col] = dd;
                  }
                }
              }
            }
          }
          // the next unit group's (or chunk's) stage A writes abuf, which the
          // k-split's partials may still be read from
          if (ksplit > 1 && (u0 + kWarps / ksplit < units || !need_c)) __syncthreads();
        }
        };
        // n-tiles a unit: 8 where W2t comes from L2 and the chunk has them (a
        // slab's bytes then cross from L2 once a chunk), else 4
        if (!WS && NT >= 8) stage_b(std::integral_constant<int, 8>{});
        else stage_b(std::integral_constant<int, 4>{});
        if (need_c) {
          __syncthreads();  // c is whole
          float* pout = part + (size_t)pbuf * D * cols;
          const int NPc = (NT + 1) >> 1;
          for (int it = warp; it < geo.MT16 * NPc; it += kWarps) {
            const int mt = it % geo.MT16, pr = it / geo.MT16;
            float a[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
            mma_tile<2>(a, W3 + mt * 128, geo.MT16 * 128, Fs / 8, cbuf + 128 * pr, npr * 128);
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              if (2 * pr + j >= NT) continue;
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                const int d = 16 * mt + g + 8 * h;
                if (d >= D) continue;
#pragma unroll
                for (int e = 0; e < 2; ++e)
                  pout[d * cols + c0 + 16 * pr + 8 * j + 2 * t + e] = a[j][2 * h + e];
              }
            }
          }
        }
      }
    };
    // after a chain with stage C: every member's partials are written
    auto exchange = [&]() {
      if (C > 1) cluster.sync();
      else __syncthreads();
    };
    // the members' partials of (d, col) summed in member order (loaded at once)
    auto reduced = [&](int d, int col) {
      const size_t i = (size_t)pbuf * D * cols + (size_t)d * cols + col;
      float p[kMaxCluster];
      p[0] = C > 1 ? cluster.map_shared_rank(part, 0)[i] : part[i];
#pragma unroll
      for (int j = 1; j < kMaxCluster; ++j)
        p[j] = j < C ? cluster.map_shared_rank(part, j)[i] : 0.f;
      float a = p[0];
#pragma unroll
      for (int j = 1; j < kMaxCluster; ++j)
        if (j < C) a += p[j];
      return a;
    };
    // g at X into G
    auto evaluate = [&](bool masks) {
      chain(std::false_type{}, X, S, S, masks, true);
      exchange();
      for (int i = tid; i < D * S; i += kThreads) {
        const int d = i / S, s = i - d * S;
        G[i] = reduced(d, s) + b3[d];
      }
      pbuf ^= 1;
      __syncthreads();
    };

    if (SOLVE) {
      for (int i = tid; i < D * S; i += kThreads) {
        const int d = i / S, s = i - d * S;
        Z[i] = X[i];
      }
      __syncthreads();
      int it = 0;
      bool moving;
      do {
        evaluate(false);
        moving = false;
        for (int i = tid; i < D * S; i += kThreads) {
          const int d = i / S, s = i - d * S;
          const float x_new = Z[i] - G[i];
          moving |= valid(s) && fabsf(x_new - X[i]) >= prm.ftol;
          X[i] = x_new;
        }
        ++it;
      } while (it < prm.n_iters && __syncthreads_or(moving));
      __syncthreads();
      // the masks at the solved x
      if (LOGDET) chain(std::false_type{}, X, S, S, true, false);
    } else {
      for (int i = tid; i < D * S; i += kThreads) {
        const int d = i / S, s = i - d * S;
        X[i] = (X[i] - an_b[d]) * expf(-an_s[d]);
      }
      __syncthreads();
      evaluate(true);
    }

    if (LOGDET) {
      for (int i = tid; i < D * cols; i += kThreads) {
        const int d = i / cols, col = i - d * cols;
        Wv[d * cols + col] = V[i];
      }
      for (int i = tid; i < kProbes * S; i += kThreads) ser[i] = 0.f;
      __syncthreads();
      for (int k = 1; k <= prm.n_sorted[0]; ++k) {
        int live = 0;
        for (int q = 0; q < kProbes; ++q) live += prm.n_sorted[q] >= k;
        const int ncols = live * S;
        chain(std::true_type{}, Wv, cols, ncols, false, true);
        exchange();
        for (int i = tid; i < D * ncols; i += kThreads) {
          const int d = i / ncols, col = i - d * ncols;
          Wv[d * cols + col] = reduced(d, col);
        }
        pbuf ^= 1;
        __syncthreads();
        for (int col = tid; col < ncols; col += kThreads) {
          float dot = 0.f;
#pragma unroll 4
          for (int d = 0; d < D; ++d) dot = fmaf(Wv[d * cols + col], V[d * cols + col], dot);
          const int q = col / S, s = col - q * S;
          float* sp = ser + prm.order[q] * S + s;
          *sp = fmaf(prm.coef[k], dot, *sp);
        }
      }
      __syncthreads();
      for (int s = tid; s < S; s += kThreads)
        acc[s] += (ser[s] + ser[S + s] + ser[2 * S + s] + ser[3 * S + s]) * 0.25f;
    }
    for (int i = tid; i < D * S; i += kThreads) {
      const int d = i / S, s = i - d * S;
      float& xv = X[i];
      xv = SOLVE ? xv * expf(an_s[d]) + an_b[d] : xv + G[i];
    }
    __syncthreads();
  }

  if (m == 0) {
    for (int i = tid; i < D * S; i += kThreads) {
      const int d = i / S, s = i - d * S;
      if (valid(s)) prm.y[(size_t)(sample0 + s) * D + d] = X[i];
    }
    if (LOGDET)
      for (int s = tid; s < S; s += kThreads)
        if (valid(s)) prm.ld[sample0 + s] = prm.ld_sign * acc[s] + prm.ld_const;
  }
  if (C > 1) cluster.sync();  // no member exits while another reads its shared memory
}

template <bool SOLVE, bool LOGDET, bool VS, bool WS>
cudaError_t launch_config(const WideParams& prm, const WideGeom& geo, cudaStream_t stream,
                          int* active_clusters) {
  auto kernel = fused_resflow_wide_kernel<SOLVE, LOGDET, VS, WS>;
  const size_t smem = (size_t)geo.smem_floats * 4;
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)((prm.B + geo.S - 1) / geo.S * geo.C), 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = geo.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (active_clusters != nullptr)
    return cudaOccupancyMaxActiveClusters(active_clusters, (void*)kernel, &cfg);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, prm);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <bool VS, bool WS>
cudaError_t launch_variant(const WideParams& prm, const WideGeom& geo, int variant,
                           cudaStream_t stream, int* active) {
  switch (variant) {
    case 0: return launch_config<true, false, VS, WS>(prm, geo, stream, active);
    case 1: return launch_config<true, true, VS, WS>(prm, geo, stream, active);
    default: return launch_config<false, true, VS, WS>(prm, geo, stream, active);
  }
}

cudaError_t dispatch(WideParams& prm, int variant, cudaStream_t stream, int* active) {
  prm.geo = WideGeom(prm.F, prm.D, prm.plan);
  const WideGeom& geo = prm.geo;
  if (!geo.valid()) return cudaErrorInvalidValue;
  if (geo.scratch_floats > 0 && prm.scratch == nullptr && active == nullptr)
    return cudaErrorInvalidValue;
  // W2t's slab is read from shared memory only with W1t and W3t staged too
  // (the planner stages all three or streams W2t)
  const bool vs = geo.vec_smem && geo.part_smem, ws = geo.w2_res && geo.w1_res && geo.w3_res;
  if (vs && ws) return launch_variant<true, true>(prm, geo, variant, stream, active);
  if (vs) return launch_variant<true, false>(prm, geo, variant, stream, active);
  if (ws) return launch_variant<false, true>(prm, geo, variant, stream, active);
  return launch_variant<false, false>(prm, geo, variant, stream, active);
}

// the probes by series length, longest first, ties by index
// (fused_resflow.py::series_order)
void series_order(const int* n_terms, int* order, int* n_sorted) {
  for (int s = 0; s < kProbes; ++s) order[s] = s;
  for (int a = 1; a < kProbes; ++a)
    for (int b = a; b > 0 && n_terms[order[b]] > n_terms[order[b - 1]]; --b) {
      const int tmp = order[b];
      order[b] = order[b - 1];
      order[b - 1] = tmp;
    }
  for (int s = 0; s < kProbes; ++s) n_sorted[s] = n_terms[order[s]];
}

WideParams make_params(int B, int n, int D, int F, int n_iters, float ftol, const int* plan) {
  WideParams prm{WideGeom(F, D, plan)};
  prm.B = B;
  prm.n = n;
  prm.D = D;
  prm.F = F;
  prm.n_iters = n_iters;
  prm.ftol = ftol;
  for (int i = 0; i < 9; ++i) prm.plan[i] = plan[i];
  for (int s = 0; s < kProbes; ++s) {
    prm.order[s] = s;
    prm.n_sorted[s] = 1;
  }
  // the same f32 operations as nf_tpu's roulette_coefficient: 2^e is exact
  for (int k = 1; k <= kMaxTerms; ++k)
    prm.coef[k] = ((k & 1) ? 1.f : -1.f) * ldexpf(1.f, k - kNExact - 1 > 0 ? k - kNExact - 1 : 0) /
                  (float)k;
  return prm;
}

}  // namespace

// Plain C entry point: one variant (0 solve, 1 solve_ld, 2 fwd_ld) on
// `stream`, returning the cudaError_t of the launch (0 on success).  w holds
// fused_resflow.py::wide_weights' blocks for the plan's cluster size; plan
// is wide_plan's 9 ints (C, S, Nc, Kc, w2_res, w1_res, w3_res, vec_smem,
// part_smem); scratch nullptr or ceil(B / S) C blocks of its scratch floats;
// n_terms (LOGDET) the host array of the 4 probes' series lengths.
extern "C" int nf_fused_resflow_wide(const void* x, void* y, void* ld, const void* w,
                                     const void* v, const int* n_terms, void* scratch, int B,
                                     int n, int D, int F, int n_iters, float ftol, int variant,
                                     float ld_sign, float ld_const, const int* plan,
                                     void* stream) {
  if (B < 1 || D < 1 || F < 1 || n < 1 || n_iters < 1 || variant < 0 || variant > 2 ||
      plan == nullptr)
    return (int)cudaErrorInvalidValue;
  const bool logdet = variant != 0;
  if (logdet && (v == nullptr || ld == nullptr || n_terms == nullptr))
    return (int)cudaErrorInvalidValue;
  WideParams prm = make_params(B, n, D, F, n_iters, ftol, plan);
  prm.x = static_cast<const float*>(x);
  prm.y = static_cast<float*>(y);
  prm.ld = static_cast<float*>(ld);
  prm.w = static_cast<const float*>(w);
  prm.v = static_cast<const float*>(v);
  prm.scratch = static_cast<float*>(scratch);
  prm.ld_sign = ld_sign;
  prm.ld_const = ld_const;
  if (logdet) {
    for (int s = 0; s < kProbes; ++s)
      if (n_terms[s] < 1 || n_terms[s] > kMaxTerms) return (int)cudaErrorInvalidValue;
    series_order(n_terms, prm.order, prm.n_sorted);
  }
  return (int)dispatch(prm, variant, static_cast<cudaStream_t>(stream), nullptr);
}

// Clusters of the plan's launch that the card holds at once
// (cudaOccupancyMaxActiveClusters), into *clusters.
extern "C" int nf_fused_resflow_wide_active_clusters(int D, int F, int variant, const int* plan,
                                                     int* clusters) {
  if (clusters == nullptr || plan == nullptr || D < 1 || F < 1) return (int)cudaErrorInvalidValue;
  WideParams prm = make_params(plan[1] * plan[0] * 132, 1, D, F, 1, 0.f, plan);
  return (int)dispatch(prm, variant < 0 || variant > 2 ? 2 : variant, nullptr, clusters);
}
