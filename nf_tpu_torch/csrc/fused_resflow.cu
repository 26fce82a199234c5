// Whole-stack eval kernels for the ResFlow 1-D density stack, Hopper (sm_90a).
//
// Replaces the three Pallas kernels of nf_tpu/ops/pallas/fused_resflow.py,
// one template variant each (SOLVE, LOGDET):
//   solve     (true,  false)  make_solve_kernel        (call_solve)
//   solve_ld  (true,  true)   make_solve_logdet_kernel (call_solve_logdet)
//   fwd_ld    (false, true)   make_fwd_logdet_kernel   (call_fwd_logdet)
// The solve at FP <= 64 is fused_resflow_solve_kernel, further down (its
// design is stated there); the template's solve variant serves FP = 128
// and 256.
// over n x [ ActNorm(D) -> InvertibleResBlock(g) ], with
//   g(x) = W3t h2 + b3,  h2 = LipSwish_b(W2t h1 + b2),  h1 = LipSwish_a(W1t x + b1),
//   LipSwish_b(a) = a s / 1.1,  s = sigmoid(b a),  LipSwish' = (s + b a s (1 - s)) / 1.1.
// forward:  x = (x - an_b) e^{-an_s};  z = x + g(x)
// inverse:  x0 = z - g(z), x <- z - g(x) while it < n_iters and some sample of
//           the tile has |x - prev| >= ftol (it from 1, x0 tested against z);
//           then x = x e^{an_s} + an_b.  The walk is reversed.
// LOGDET adds, per block at its input x (the solved x when SOLVE), the
// 'unbias' series of every probe s: with D1, D2 the LipSwish' masks at x,
//   w <- W1 (D1 (W2 (D2 (W3 w)))) = J^T w  from w = v_s,
//   ser_s += (-1)^(k+1) 2^max(0, k - n_exact - 1) / k * (w . v_s),  k = 1..n_terms[s],
// and acc += (ser_0 + ser_1 + ser_2 + ser_3) / 4.  ld = ld_sign * acc + ld_const:
// the host passes +1, -an_const (forward) or -1, +an_const (inverse), as
// nf_tpu's call_*_logdet add the ActNorm constant outside their kernels.
//
// Bound (H100 SXM): one g evaluation is D F + F^2 + F D multiply-adds per
// sample, and one J^T product the same (1,152 at D = 2, F = 32).  Per sample
// and block the forward does 1 evaluation and sum_s n_terms products (42 at
// the port's probes), the inverse the solve's it + 1 evaluations (4-5) and
// the same products: about 2.5e10 flop per direction at B = 8192, n = 32.
// With the F x F products on the tensor cores in 3xTF32 (165 TFLOP/s for
// f32-accurate products) and the rest at 67 TFLOP/s that is about 0.16 ms;
// all on the FFMA units 0.4 ms.  Weights and x / z / probes / logdet
// (under 1 MB) are read or written once: operations bound the kernel.
//
// Design.
//  * The F x F products run on the tensor cores: mma.sync.m16n8k8 TF32 in
//    the 3xTF32 split of csrc/attention.cu (x = big + small, big in TF32,
//    a b ~ big big + big small + small big, small products first).  The
//    matrix is the A operand (M = output features, K = input features),
//    8 columns are the N dimension.  Both matrices, W2 for the series'
//    J^T products and W2t for g's hidden layer, are split once on the host
//    (fused_resflow.py::kernel_weights: big rounded to nearest on the
//    bits, small = x - big) and laid out in A-fragment order, [KS][MT][big,
//    small][lane][4]: a lane reads its four big and four small values of a
//    16 x 8 tile with two 16-byte loads.  The column side (t = D2 (W3 w) in
//    the series, h1 in g) is formed in registers directly in the B layout
//    (lane 4 g + t holds column g, features 8 ks + t and 8 ks + t + 4) and
//    split by truncation.  The D-wide products W3 w, W1 u and W1t x stay
//    on the FFMA units; at FP DP <= 64 the series keeps W3t D2 and W1t D1
//    (the masks folded into this lane's weights, constant over the terms)
//    in registers.
//  * A block is a tile of 16 samples (two groups of 8, one mma's N) and 4
//    warps: warp w works on group gamma = w & 1.  At B = 8192 that is 512
//    blocks, 3-4 resident on every one of the 132 SMs (12-16 warps each).
//  * g's evaluations split the warps of a group by output features: warp
//    pi = w >> 1 computes half of h1 (to shared memory), then the W2t h1
//    product for its half of the m-tiles, h2, and its partial of g (the W3t
//    fold reduced over the fragment's rows by warp shuffles), which the
//    two warps add through shared memory.  Two barriers per evaluation.
//  * The series: each warp runs two probes of its group (two 8-column
//    n-tiles that share every W2 fragment load and the masks).  The host
//    sorts the probes by n_terms, a >= b >= c >= d, and gives one warp
//    {a, d} and the other {b, c} (probe_pairs in fused_resflow.py), so a
//    block takes max(a + d, b + c) terms, not 4 max: 23 against a mean of
//    21 at the port's probes [10, 14, 9, 9].  The two n-tiles run together
//    while both probes last, then the longer alone.  Per term the
//    accumulator (C layout: rows 16 mt + g, + 8; columns 2 t, 2 t + 1) is
//    multiplied by D1 and folded through W1 in registers, reduced over the
//    8 row lanes by xor shuffles that scatter the two columns (the first
//    step keeps one column and sends the other), and gathered back to the
//    B layout: four shuffles per dimension and n-tile.  The coefficients
//    come from the host (Params::coef).  Each probe's series is summed in its own
//    order and the block's four series are added in probe order through
//    shared memory, as nf_tpu does.
//  * Stopping is per block (its tile): __syncthreads_or over the tile's valid
//    samples keeps the threads in step.  nf_tpu stops per batch tile and its
//    chain on the whole batch; all stop only where max|x - prev| < ftol.
//  * Weights: one residual block's weight block is its small tensors
//    (W1t, biases, W3t, ActNorm, betas) followed by the two fragment
//    arrays; fused_resflow.py::kernel_weights lays it out.  Up to FP = 64
//    the whole block is staged into shared memory with cp.async, double
//    buffered one block ahead (70 KB at FP = 64, DP = 8).  At FP >= 128 the
//    fragments (256 KB at FP = 128, 1 MB at FP = 256) stay in device
//    memory and each warp streams the chunks it multiplies, one k-step of
//    up to 8 m-tiles at a time, through its own two-slot cp.async ring in
//    shared memory: every lane copies exactly the 16-byte pieces it then
//    reads, so the ring needs no barrier.
//  * Widths: FP in {16, 32, 64, 128, 256} and DP in {2, 4, 8}, zero-padded on
//    the host: padded features and dimensions stay exactly 0.  Wider stacks
//    run fused_resflow_wide_kernel (csrc/fused_resflow_wide.cu).
//  * Numerics: accurate expf and IEEE division, no fast math.
//  * On an H100 (chip_smoke.py, B = 8192, n = 32, F = 32, D = 2) fwd_ld
//    takes 0.46 ms and solve_ld 0.62 ms (the FFMA design before this one:
//    1.35 / 1.76 ms).  Per term and pair of n-tiles the series runs 48
//    mma and about 195 other instructions (cuobjdump -sass); mma.sync
//    does not reach wgmma's TF32 rate, so the series is bound by the mma
//    issue rate first and the W2 fragment loads second.  Slower on the
//    way: three partial accumulators per tile, W2's first m-tile held in
//    registers, blocks of 8 warps (32 samples), and swapping the probe
//    pairs between the two warps at every block.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "bulk_ring.cuh"

namespace {

constexpr int kProbes = 4;
constexpr int kGroups = 2;          // groups of 8 samples (one mma's N) per block
constexpr int kS = 8 * kGroups;     // samples per block
constexpr int kWarps = 2 * kGroups; // two per group: warp w has group w % kGroups
constexpr int kT = 32 * kWarps;     // threads per block
constexpr int kSS = kS + 8;      // row stride of the [feature][sample] scratch
constexpr int kNExact = 8;       // the serving estimator's n_exact
constexpr int kMaxTerms = kNExact + 32;
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* x;      // (B, D) input
  float* y;            // (B, D) output
  float* ld;           // (B,) log-det (LOGDET)
  const float* w;      // (n, Layout::kSize) per-block weight blocks
  const float* v;      // (S, B, D) probes (LOGDET)
  int n_terms[kProbes];
  int pair[2][2];      // the probes of the warps pi = 0, 1: [pi][0] the longer
  float coef[kMaxTerms + 1];  // term k's weight (-1)^(k+1) 2^max(0, k - n_exact - 1) / k
  int B, n, D, n_iters;
  float ftol, ld_sign, ld_const;
};

// One residual block's weight block, floats from its start;
// fused_resflow.py's Layout mirrors this.
template <int FP, int DP>
struct Layout {
  static constexpr int kMT = FP / 16;  // m-tiles of 16 output features
  static constexpr int kKS = FP / 8;   // k-steps of 8 input features
  static constexpr bool kStream = FP >= 128;
  static constexpr int kW1t = 0;                  // [FP][DP]
  static constexpr int kB1 = FP * DP;             // [FP]
  static constexpr int kB2 = kB1 + FP;            // [FP]
  static constexpr int kW3t = kB2 + FP;           // [DP][FP]
  static constexpr int kB3 = kW3t + DP * FP;      // [DP]
  static constexpr int kAnS = kB3 + DP;           // [DP]
  static constexpr int kAnB = kAnS + DP;          // [DP]
  static constexpr int kBeta = kAnB + DP;         // [2]
  static constexpr int kSmall = (kBeta + 2 + 3) & ~3;
  static constexpr int kW2 = kSmall;              // W2 = W2t^T fragments [KS][MT][2][32][4]
  static constexpr int kW2t = kW2 + 2 * FP * FP;  // W2t fragments, the same
  static constexpr int kSize = kW2t + 2 * FP * FP;
  static constexpr int kStaged = kStream ? kSmall : kSize;  // floats staged per block
  static constexpr int kCM = kMT < 8 ? kMT : 8;   // m-tiles per streamed chunk
  static constexpr int kRing = kStream ? 2 * kCM * 256 : 0;  // ring floats per warp
  // the series keeps W3t D2 and W1t D1 (the weights times the masks,
  // constant over the terms) of its rows in registers
  static constexpr bool kRegW = !kStream && FP * DP <= 64;
};

// shared floats of one block; fused_resflow.py::smem_bytes mirrors this
template <int FP, int DP>
constexpr int smem_floats() {
  using L = Layout<FP, DP>;
  return 2 * L::kStaged + kWarps * L::kRing + 3 * FP * kSS + kProbes * kS + 2 * kS * DP;
}

__device__ __forceinline__ float sigmoid(float a) { return 1.f / (1.f + expf(-a)); }

// LipSwish and its derivative at the pre-activation a
__device__ __forceinline__ void lipswish(float a, float beta, float& h, float& d) {
  const float s = sigmoid(beta * a);
  h = a * s / 1.1f;
  d = (s + beta * a * s * (1.f - s)) / 1.1f;
}

// x = big + small, big = x truncated to TF32 (one instruction) and small =
// x - big exactly, |small| < 2^-10 |x|; the tensor core reads small's top
// 19 bits.  The A side (the weights) was rounded to nearest on the host, so
// the dropped small * small term stays below 2^-21 of |a b|.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint4& a, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a.x), "r"(a.y), "r"(a.z), "r"(a.w), "r"(b0), "r"(b1));
}

// c += a b in 3xTF32, the small products first; frag: a's big part, its
// small part 128 floats on
__device__ __forceinline__ void mma3(float (&c)[4], const float* frag, const uint32_t (&bb)[2],
                                     const uint32_t (&bs)[2]) {
  const uint4 ab = *reinterpret_cast<const uint4*>(frag);
  const uint4 as = *reinterpret_cast<const uint4*>(frag + 128);
  mma(c, ab, bs[0], bs[1]);
  mma(c, as, bb[0], bb[1]);
  mma(c, ab, bb[0], bb[1]);
}

// Shared scratch of the tile, [FP][kSS] each (samples along the row).
struct Scratch {
  float* h1;
  float* d1;
  float* d2;
  float* red;    // [kProbes][kS] the block's series
  float* gpart;  // [2][kS][DP] the two feature halves' partial g
};

// acc[i][n] = A(m-tile mt0 + i) B(n) over every k-step, for the nm
// m-tiles mt0 .. mt0 + nm - 1 (nm <= NM).  A's fragments are `frags`: in
// shared memory (staged with the block), or at FP >= 128 in device memory,
// streamed chunk by chunk through this warp's `ring`.  make_b(ks, bb, bs)
// forms the B fragments of k-step ks for the NT n-tiles.
template <int FP, int DP, int NM, int NT, class MakeB>
__device__ __forceinline__ void product(const float* frags, float* ring, int mt0, int nm,
                                        int lane, MakeB&& make_b, float (&acc)[NM][2][4]) {
  using L = Layout<FP, DP>;
#pragma unroll
  for (int i = 0; i < NM; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][n][r] = 0.f;
  if constexpr (!L::kStream) {
#pragma unroll
    for (int ks = 0; ks < L::kKS; ++ks) {
      uint32_t bb[2][2], bs[2][2];
      make_b(ks, bb, bs);
#pragma unroll
      for (int i = 0; i < NM; ++i) {
        if (i < nm) {
          const float* f = frags + ((ks * L::kMT + mt0 + i) * 2) * 128 + 4 * lane;
#pragma unroll
          for (int n = 0; n < NT; ++n) mma3(acc[i][n], f, bb[n], bs[n]);
        }
      }
    }
  } else {
    constexpr int CM = L::kCM;
    constexpr int NCH = (NM + CM - 1) / CM;  // chunks per k-step
    constexpr int Q = L::kKS * NCH;
    float* mine = ring + 4 * lane;
    // chunk q: k-step q / NCH, m-tiles mt0 + (q % NCH) CM ..., into slot q & 1
    auto issue = [&](int q) {
      if (q >= Q) return;
      const int ks = q / NCH, c = q - (q / NCH) * NCH;
      const int cnt = min(CM, nm - c * CM);
      const float* src = frags + ((ks * L::kMT + mt0 + c * CM) * 2) * 128 + 4 * lane;
      float* dst = mine + (q & 1) * CM * 256;
      for (int p = 0; p < 2 * cnt; ++p) __pipeline_memcpy_async(dst + p * 128, src + p * 128, 16);
    };
    issue(0);
    __pipeline_commit();
#pragma unroll 1
    for (int ks = 0; ks < L::kKS; ++ks) {
      uint32_t bb[2][2], bs[2][2];
      make_b(ks, bb, bs);
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
        const int q = ks * NCH + c;
        issue(q + 1);
        __pipeline_commit();
        __pipeline_wait_prior(1);  // chunk q has landed (this lane's own pieces)
        const float* slot = mine + (q & 1) * CM * 256;
#pragma unroll
        for (int j = 0; j < CM; ++j) {
          const int i = c * CM + j;
          if (i < NM && i < nm) {
#pragma unroll
            for (int n = 0; n < NT; ++n) mma3(acc[i][n], slot + 2 * j * 128, bb[n], bs[n]);
          }
        }
      }
    }
  }
}

// One evaluation of g at this lane's sample x (column g of its group): h1
// by features split over the group's two warps into shared memory (d1 with
// MASKS), then h2 = LipSwish(W2t h1 + b2) for this warp's half of the
// m-tiles (d2 with MASKS) and, with NEED_G, g = W3t h2 + b3 into gout.
// Two barriers; on return the masks are visible to every thread.
template <int FP, int DP, bool MASKS, bool NEED_G>
__device__ __forceinline__ void evaluate(const float* wc, const float* frags, float* ring,
                                         const Scratch& s, const float (&x)[DP],
                                         float (&gout)[DP], int lane, int gamma, int pi) {
  using L = Layout<FP, DP>;
  constexpr int MH = (L::kMT + 1) / 2;
  const int g = lane >> 2, t = lane & 3;
  const int col = 8 * gamma + g;
  const float beta_a = wc[L::kBeta], beta_b = wc[L::kBeta + 1];
  // h1: features pi FP / 2 + t + 4 j of sample col
#pragma unroll (FP <= 64 ? FP / 8 : 4)
  for (int j = 0; j < FP / 8; ++j) {
    const int f = pi * (FP / 2) + t + 4 * j;
    float a = 0.f;
#pragma unroll
    for (int d = 0; d < DP; ++d) a = fmaf(wc[L::kW1t + f * DP + d], x[d], a);
    float h, dd;
    lipswish(a + wc[L::kB1 + f], beta_a, h, dd);
    s.h1[f * kSS + col] = h;
    if (MASKS) s.d1[f * kSS + col] = dd;
  }
  __syncthreads();
  const int mt0 = pi ? L::kMT - L::kMT / 2 : 0;
  const int nm = pi ? L::kMT / 2 : L::kMT - L::kMT / 2;
  float acc[MH][2][4];
  product<FP, DP, MH, 1>(frags, ring, mt0, nm, lane,
                         [&](int ks, uint32_t (&bb)[2][2], uint32_t (&bs)[2][2]) {
                           const int k0 = 8 * ks + t;
                           split(s.h1[k0 * kSS + col], bb[0][0], bs[0][0]);
                           split(s.h1[(k0 + 4) * kSS + col], bb[0][1], bs[0][1]);
                         },
                         acc);
  float gp[2][DP];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int d = 0; d < DP; ++d) gp[c][d] = 0.f;
  const int c0 = 8 * gamma + 2 * t;  // the C fragment's columns c0, c0 + 1
#pragma unroll
  for (int i = 0; i < MH; ++i) {
    if (i < nm) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // (row, column) = (g | g + 8, c0 | c0 + 1)
        const int o = 16 * (mt0 + i) + g + 8 * (r >> 1), c = r & 1;
        float h, dd;
        lipswish(acc[i][0][r] + wc[L::kB2 + o], beta_b, h, dd);
        if (MASKS) s.d2[o * kSS + c0 + c] = dd;
        if (NEED_G) {
#pragma unroll
          for (int d = 0; d < DP; ++d) gp[c][d] = fmaf(wc[L::kW3t + d * FP + o], h, gp[c][d]);
        }
      }
    }
  }
  if (NEED_G) {
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int d = 0; d < DP; ++d) {
        float v = gp[c][d];
        v += __shfl_xor_sync(kFull, v, 4);
        v += __shfl_xor_sync(kFull, v, 8);
        v += __shfl_xor_sync(kFull, v, 16);
        if (g == 0) s.gpart[(pi * kS + c0 + c) * DP + d] = v;
      }
  }
  __syncthreads();
  if (NEED_G) {
#pragma unroll
    for (int d = 0; d < DP; ++d)
      gout[d] = s.gpart[col * DP + d] + s.gpart[(kS + col) * DP + d] + wc[L::kB3 + d];
  }
}

// The roulette series of this warp's two probes at the masks d1 / d2: for
// n-tile n (probe pair[pi][n]) and this lane's column g,
// ser[n] = sum_{k <= nt[n]} coef_k v . (J^T)^k v.  nt[0] >= nt[1].
template <int FP, int DP>
__device__ __forceinline__ void series(const Params& prm, const float* wc, const float* frags,
                                       float* ring, const Scratch& s, const float (&v)[2][DP],
                                       const int (&nt)[2], float (&ser)[2], int lane,
                                       int gamma) {
  using L = Layout<FP, DP>;
  constexpr int MT = L::kMT, KS = L::kKS;
  constexpr bool kRegW = L::kRegW;
  const int g = lane >> 2, t = lane & 3;
  const int col = 8 * gamma + g, c0 = 8 * gamma + 2 * t;
  // the masks: D2 in the B layout (features 8 ks + t, + 4 of column col),
  // D1 in the C layout (features 16 mt + g, + 8 of columns c0, c0 + 1);
  // with kRegW multiplied once into this lane's W3t columns and W1t rows
  // (registers), else read from shared memory at each use
  float w3d2[kRegW ? KS : 1][2][DP];
  float w1d1[kRegW ? MT : 1][2][2][DP];
  if constexpr (kRegW) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int k = 8 * ks + t + 4 * h;
#pragma unroll
        for (int d = 0; d < DP; ++d)
          w3d2[ks][h][d] = wc[L::kW3t + d * FP + k] * s.d2[k * kSS + col];
      }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = 16 * mt + g + 8 * h;
        const float2 m = *reinterpret_cast<const float2*>(s.d1 + o * kSS + c0);
#pragma unroll
        for (int d = 0; d < DP; ++d) {
          w1d1[mt][h][0][d] = wc[L::kW1t + o * DP + d] * m.x;
          w1d1[mt][h][1][d] = wc[L::kW1t + o * DP + d] * m.y;
        }
      }
  }
  float w[2][DP];
#pragma unroll
  for (int n = 0; n < 2; ++n) {
    ser[n] = 0.f;
#pragma unroll
    for (int d = 0; d < DP; ++d) w[n][d] = v[n][d];
  }
  const int odd = g & 1;
  const int src = 4 * odd + (g >> 1);  // after the reduction: holds column g
  // one term k for the first NT n-tiles
  auto term = [&](auto nt_tag, int k) {
    constexpr int NT = decltype(nt_tag)::value;
    float acc[MT][2][4];
    product<FP, DP, MT, NT>(
        frags, ring, 0, MT, lane,
        [&](int ks, uint32_t (&bb)[2][2], uint32_t (&bs)[2][2]) {
          const int k0 = 8 * ks + t;
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            float a0 = 0.f, a1 = 0.f;
            if constexpr (kRegW) {  // t = (W3t D2) w
#pragma unroll
              for (int d = 0; d < DP; ++d) {
                a0 = fmaf(w3d2[ks][0][d], w[n][d], a0);
                a1 = fmaf(w3d2[ks][1][d], w[n][d], a1);
              }
            } else {  // t = D2 (W3t w)
              const float m0 = s.d2[k0 * kSS + col], m1 = s.d2[(k0 + 4) * kSS + col];
#pragma unroll
              for (int d = 0; d < DP; ++d) {
                a0 = fmaf(wc[L::kW3t + d * FP + k0], w[n][d], a0);
                a1 = fmaf(wc[L::kW3t + d * FP + k0 + 4], w[n][d], a1);
              }
              a0 *= m0;
              a1 *= m1;
            }
            split(a0, bb[n][0], bs[n][0]);
            split(a1, bb[n][1], bs[n][1]);
          }
        },
        acc);
    // W1 (D1 .) over this lane's rows, for columns c0 + c
    float wn[2][2][DP];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int d = 0; d < DP; ++d) wn[n][c][d] = 0.f;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int o = 16 * mt + g + 8 * h;
        const float2 m = kRegW ? make_float2(0.f, 0.f)
                               : *reinterpret_cast<const float2*>(s.d1 + o * kSS + c0);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const float a = acc[mt][n][2 * h + c];
#pragma unroll
            for (int d = 0; d < DP; ++d) {
              if constexpr (kRegW) {
                wn[n][c][d] = fmaf(w1d1[mt][h][c][d], a, wn[n][c][d]);
              } else {
                wn[n][c][d] = fmaf(wc[L::kW1t + o * DP + d], a * (c ? m.y : m.x), wn[n][c][d]);
              }
            }
          }
        }
      }
    }
    // the sum over the 8 row lanes, scattered: the xor-4 step keeps column
    // c0 + (g & 1) and sends the other; then each lane gathers column g
    const float coef = prm.coef[k];
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < DP; ++d) {
        const float keep = odd ? wn[n][1][d] : wn[n][0][d];
        const float send = odd ? wn[n][0][d] : wn[n][1][d];
        float r = keep + __shfl_xor_sync(kFull, send, 4);
        r += __shfl_xor_sync(kFull, r, 8);
        r += __shfl_xor_sync(kFull, r, 16);
        w[n][d] = __shfl_sync(kFull, r, src);
        dot = fmaf(w[n][d], v[n][d], dot);
      }
      ser[n] = fmaf(coef, dot, ser[n]);
    }
  };
  int k = 1;
  for (; k <= nt[1]; ++k) term(std::integral_constant<int, 2>{}, k);
  for (; k <= nt[0]; ++k) term(std::integral_constant<int, 1>{}, k);
}

template <int FP, int DP, bool SOLVE, bool LOGDET>
__global__ void __launch_bounds__(kT, FP <= 32 ? 4 : 1) fused_resflow_kernel(const Params prm) {
  using L = Layout<FP, DP>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gamma = warp % kGroups, pi = warp / kGroups;
  const int g = lane >> 2, t = lane & 3;
  const int col = 8 * gamma + g;  // this lane's sample in the tile
  float* buf = smem;                              // 2 x kStaged
  float* ring = buf + 2 * L::kStaged + warp * L::kRing;
  float* scratch = buf + 2 * L::kStaged + kWarps * L::kRing;
  const Scratch s{scratch, scratch + FP * kSS, scratch + 2 * FP * kSS, scratch + 3 * FP * kSS,
                  scratch + 3 * FP * kSS + kProbes * kS};
  const int sample = blockIdx.x * kS + col;
  const bool valid = sample < prm.B;
  const int D = prm.D;

  auto block_of = [&](int step) { return SOLVE ? prm.n - 1 - step : step; };
  auto stage = [&](int step) {
    const float* src = prm.w + (size_t)block_of(step) * L::kSize;
    float* dst = buf + (step & 1) * L::kStaged;
    for (int i = tid; i < L::kStaged / 4; i += kT)
      __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
  };
  stage(0);
  __pipeline_commit();

  float x[DP], v[2][DP], acc = 0.f;
  int nt[2] = {0, 0}, probe[2] = {0, 0};
  if (LOGDET) {
#pragma unroll
    for (int n = 0; n < 2; ++n) {
      probe[n] = prm.pair[pi][n];
      nt[n] = prm.n_terms[probe[n]];
    }
  }
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    x[d] = (valid && d < D) ? prm.x[(size_t)sample * D + d] : 0.f;
#pragma unroll
    for (int n = 0; n < 2; ++n)
      v[n][d] = (LOGDET && valid && d < D)
                    ? prm.v[((size_t)probe[n] * prm.B + sample) * D + d] : 0.f;
  }

  for (int step = 0; step < prm.n; ++step) {
    // block `step` has landed and everyone is done with step - 1, whose
    // slot the next block now fills
    __pipeline_wait_prior(0);
    __syncthreads();
    if (step + 1 < prm.n) stage(step + 1);
    __pipeline_commit();
    const float* wc = buf + (step & 1) * L::kStaged;
    const float* base = L::kStream ? prm.w + (size_t)block_of(step) * L::kSize : wc;
    const float* w2 = base + L::kW2;
    const float* w2t = base + L::kW2t;
    float gv[DP];

    if (SOLVE) {
      float z[DP], prev[DP];
#pragma unroll
      for (int d = 0; d < DP; ++d) z[d] = prev[d] = x[d];
      evaluate<FP, DP, false, true>(wc, w2t, ring, s, z, gv, lane, gamma, pi);
#pragma unroll
      for (int d = 0; d < DP; ++d) x[d] = z[d] - gv[d];
      int it = 1;
      while (true) {
        bool moving = false;
#pragma unroll
        for (int d = 0; d < DP; ++d) moving |= valid && fabsf(x[d] - prev[d]) >= prm.ftol;
        if (!(it < prm.n_iters && __syncthreads_or(moving))) break;
#pragma unroll
        for (int d = 0; d < DP; ++d) prev[d] = x[d];
        evaluate<FP, DP, false, true>(wc, w2t, ring, s, x, gv, lane, gamma, pi);
#pragma unroll
        for (int d = 0; d < DP; ++d) x[d] = z[d] - gv[d];
        ++it;
      }
      // the masks at the solved x
      if (LOGDET) evaluate<FP, DP, true, false>(wc, w2t, ring, s, x, gv, lane, gamma, pi);
    } else {
#pragma unroll
      for (int d = 0; d < DP; ++d) x[d] = (x[d] - wc[L::kAnB + d]) * expf(-wc[L::kAnS + d]);
      evaluate<FP, DP, true, true>(wc, w2t, ring, s, x, gv, lane, gamma, pi);
    }

    if (LOGDET) {
      float ser[2];
      series<FP, DP>(prm, wc, w2, ring, s, v, nt, ser, lane, gamma);
      if (t == 0) {
        s.red[probe[0] * kS + col] = ser[0];
        s.red[probe[1] * kS + col] = ser[1];
      }
      __syncthreads();
      acc += (s.red[col] + s.red[kS + col] + s.red[2 * kS + col] + s.red[3 * kS + col]) * 0.25f;
    }
#pragma unroll
    for (int d = 0; d < DP; ++d)
      x[d] = SOLVE ? x[d] * expf(wc[L::kAnS + d]) + wc[L::kAnB + d] : x[d] + gv[d];
  }

  if (pi == 0 && t == 0 && valid) {
#pragma unroll
    for (int d = 0; d < DP; ++d)
      if (d < D) prm.y[(size_t)sample * D + d] = x[d];
    if (LOGDET) prm.ld[sample] = prm.ld_sign * acc + prm.ld_const;
  }
}

// ---- the solve: a warp per 8 samples, no block barriers
//
// fused_resflow_solve_kernel computes what variant 0 (solve) computes, for
// FP <= 64 (16, 32, 64) and DP in {2, 4, 8}.
//  * Bound (H100 SXM, B = 8192, n = 32, F = 32, D = 2, 3-4 trips a
//    block): 0.013 ms with W2t h1 on the tensor cores in 3xTF32 and one
//    SFU operation per sigmoid; operations bound it, not bytes.
//  * A consumer warp owns 8 samples (one mma's N) for the whole walk, so
//    nothing crosses warps inside a fixed-point trip: h1 is formed in the
//    B layout, W2t h1 runs over all m-tiles, h2 and the W3t fold stay in
//    the C layout, reduced by xor shuffles and gathered back, and the
//    stop is an __any_sync over the warp's samples.  The series kernels'
//    16-sample blocks instead split g's features over two warps and met
//    at two block barriers per evaluation.
//  * The weights arrive through a ring of residual-block slots (the
//    block's small tensors and W2t fragments, 8,992 bytes at FP = 32,
//    DP = 2), filled by a producer warp with bulk copies that complete on
//    mbarriers (csrc/bulk_ring.cuh); consumer warps wait on full barriers
//    and release empty ones, and move through the residual blocks on
//    their own.  4 slots up to FP = 32, 2 at FP = 64 (37 KB a slot).
//  * Blocks of 4 consumer warps: 256 at B = 8192, one wave with a block on
//    every SM (blocks of 8 measured about 8 % faster on an H100 but leave
//    4 SMs idle).
//  * LipSwish in lipswish_h's cheaper form: the arithmetic per hidden unit,
//    not the mma, set the pace of this layout.
//  * What bounds it (H100, F = 32): each warp's serial chain per g
//    evaluation (h1, the 12-deep mma chains, h2, the shuffles) with about
//    8 warps on an SM, two per scheduler.

constexpr int kSolveWarps = 4;                   // consumer warps per block
constexpr int kSolveThreads = 32 * (kSolveWarps + 1);  // and one producer warp
constexpr int kSolveSamples = 8 * kSolveWarps;
constexpr int kSolveBarBytes = 128;  // the ring's mbarriers, ahead of the ring

// ring slots: residual blocks in flight
__host__ __device__ constexpr int solve_slots(int fp) { return fp <= 32 ? 4 : 2; }

// one residual block's slot: its small tensors at Layout's offsets, then
// the W2t fragments (W2 is the series' and stays in device memory)
template <int FP, int DP>
struct SolveSlot {
  using L = Layout<FP, DP>;
  static constexpr int kW2t = L::kSmall;
  static constexpr int kSize = L::kSmall + 2 * FP * FP;
};

template <int FP, int DP>
constexpr int solve_smem_bytes() {
  return kSolveBarBytes + 4 * solve_slots(FP) * SolveSlot<FP, DP>::kSize;
}

struct SolveParams {
  const float* x;  // (B, D) z
  float* y;        // (B, D) x
  const float* w;  // (n, Layout::kSize) the weight blocks, as the series kernels read them
  int B, n, D, n_iters;
  float ftol;
};

// LipSwish h = a s / 1.1, s = sigmoid(beta a), for the solve: __expf,
// __fdividef and a multiply by the f32 constant 1 / 1.1.  On an H100 at
// B = 8192, F = 32 this form takes the solve from 0.24 to 0.10 ms against
// accurate expf and IEEE divisions (the series kernels' form), and moves
// x by under 2e-5 against the plain version (chip_smoke.py holds 1e-3).
__device__ __forceinline__ float lipswish_h(float a, float beta) {
  return a * __fdividef(1.f, 1.f + __expf(-(beta * a))) * (1.f / 1.1f);
}

// g at this lane's sample x (sample g of the warp): gout[d] for every d,
// the same on the quad's four lanes.  wc is the residual block's slot.
//  h1 is formed in the B layout: lane 4 g + t computes features 8 ks + t
//  and 8 ks + t + 4 of its sample, split for 3xTF32.  W2t h1 runs on
//  mma.sync over all m-tiles (independent accumulator chains).  h2 and the
//  W3t fold stay in the C layout (rows 16 mt + g, + 8; columns 2 t, 2 t + 1),
//  reduced over the 8 row lanes by xor shuffles that scatter the two
//  columns, then gathered back to sample g.
template <int FP, int DP>
__device__ __forceinline__ void warp_g(const float* wc, const float (&x)[DP], float (&gout)[DP],
                                       int lane) {
  using L = Layout<FP, DP>;
  constexpr int MT = L::kMT, KS = L::kKS;
  const int g = lane >> 2, t = lane & 3;
  const float beta_a = wc[L::kBeta], beta_b = wc[L::kBeta + 1];
  const float* frags = wc + SolveSlot<FP, DP>::kW2t + 4 * lane;
  float acc[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[mt][r] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t bb[2], bs[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int f = 8 * ks + t + 4 * h;
      float a = 0.f;
#pragma unroll
      for (int d = 0; d < DP; ++d) a = fmaf(wc[L::kW1t + f * DP + d], x[d], a);
      split(lipswish_h(a + wc[L::kB1 + f], beta_a), bb[h], bs[h]);
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) mma3(acc[mt], frags + (ks * MT + mt) * 256, bb, bs);
  }
  float gp[2][DP];
#pragma unroll
  for (int c = 0; c < 2; ++c)
#pragma unroll
    for (int d = 0; d < DP; ++d) gp[c][d] = 0.f;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 4; ++r) {  // (row, column) = (16 mt + g | + 8, 2 t | 2 t + 1)
      const int o = 16 * mt + g + 8 * (r >> 1), c = r & 1;
      const float h = lipswish_h(acc[mt][r] + wc[L::kB2 + o], beta_b);
#pragma unroll
      for (int d = 0; d < DP; ++d) gp[c][d] = fmaf(wc[L::kW3t + d * FP + o], h, gp[c][d]);
    }
  // the xor-4 step keeps column 2 t + (g & 1) and sends the other; after the
  // xor-8 and xor-16 steps lane 4 g + t holds that column's sum, so sample g
  // is on lane 4 (g & 1) + (g >> 1)
  const int odd = g & 1, src = 4 * odd + (g >> 1);
#pragma unroll
  for (int d = 0; d < DP; ++d) {
    const float keep = odd ? gp[1][d] : gp[0][d];
    const float send = odd ? gp[0][d] : gp[1][d];
    float r = keep + __shfl_xor_sync(kFull, send, 4);
    r += __shfl_xor_sync(kFull, r, 8);
    r += __shfl_xor_sync(kFull, r, 16);
    gout[d] = __shfl_sync(kFull, r, src) + wc[L::kB3 + d];
  }
}

// kSolveWarps consumer warps and one producer warp per block.  Stopping is
// per warp: a warp's 8 samples leave a residual block's fixed point when
// it == n_iters or max|x - prev| < ftol over its valid samples.  nf_tpu
// stops per batch tile and its chain on the whole batch; all stop only
// where max|x - prev| < ftol.
template <int FP, int DP>
__global__ void __launch_bounds__(kSolveThreads) fused_resflow_solve_kernel(const SolveParams prm) {
  using L = Layout<FP, DP>;
  using SL = SolveSlot<FP, DP>;
  constexpr int S = solve_slots(FP);
  extern __shared__ __align__(16) float smem[];  // the series kernels' declaration
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + S;
  float* ring = smem + kSolveBarBytes / 4;
  static_assert(2 * S * 8 <= kSolveBarBytes, "the barriers outgrow their room");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = prm.n;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      bar_init(&full[i], 1);
      bar_init(&empty[i], kSolveWarps);
    }
    bar_init_fence();
  }
  __syncthreads();

  if (warp == kSolveWarps) {
    // the producer: residual block n - 1 - s into slot s % S, once the
    // consumers have released the slot
    if (lane == 0) {
      for (int s = 0; s < n; ++s) {
        const int slot = s % S;
        const float* src = prm.w + (size_t)(n - 1 - s) * L::kSize;
        float* dst = ring + slot * SL::kSize;
        bar_wait(&empty[slot], ((s / S) & 1) ^ 1);
        bar_expect(&full[slot], 4 * SL::kSize);
        bulk_load(dst, src, 4 * L::kSmall, &full[slot]);
        bulk_load(dst + SL::kW2t, src + L::kW2t, 8 * FP * FP, &full[slot]);
      }
    }
    return;
  }

  const int sample = (blockIdx.x * kSolveWarps + warp) * 8 + (lane >> 2);
  const bool valid = sample < prm.B;
  const int D = prm.D;
  float x[DP];
#pragma unroll
  for (int d = 0; d < DP; ++d) x[d] = (valid && d < D) ? prm.x[(size_t)sample * D + d] : 0.f;

  for (int s = 0; s < n; ++s) {
    const int slot = s % S;
    bar_wait(&full[slot], (s / S) & 1);
    const float* wc = ring + slot * SL::kSize;
    float z[DP], prev[DP], gv[DP];
#pragma unroll
    for (int d = 0; d < DP; ++d) z[d] = prev[d] = x[d];
    warp_g<FP, DP>(wc, z, gv, lane);
#pragma unroll
    for (int d = 0; d < DP; ++d) x[d] = z[d] - gv[d];
    for (int it = 1; it < prm.n_iters; ++it) {
      bool moving = false;
#pragma unroll
      for (int d = 0; d < DP; ++d) moving |= valid && fabsf(x[d] - prev[d]) >= prm.ftol;
      if (!__any_sync(kFull, moving)) break;
#pragma unroll
      for (int d = 0; d < DP; ++d) prev[d] = x[d];
      warp_g<FP, DP>(wc, x, gv, lane);
#pragma unroll
      for (int d = 0; d < DP; ++d) x[d] = z[d] - gv[d];
    }
    // ActNorm inverse
#pragma unroll
    for (int d = 0; d < DP; ++d) x[d] = x[d] * expf(wc[L::kAnS + d]) + wc[L::kAnB + d];
    __syncwarp();
    if (lane == 0) bar_arrive(&empty[slot]);
  }

  if ((lane & 3) == 0 && valid) {
#pragma unroll
    for (int d = 0; d < DP; ++d)
      if (d < D) prm.y[(size_t)sample * D + d] = x[d];
  }
}

template <int FP, int DP>
cudaError_t launch_solve(const SolveParams& prm, cudaStream_t stream, int* blocks_per_sm) {
  constexpr int smem = solve_smem_bytes<FP, DP>();
  auto kernel = fused_resflow_solve_kernel<FP, DP>;
  static bool opted_in = false;  // above 48 KB a block needs the opt-in
  if (!opted_in) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  if (blocks_per_sm != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kSolveThreads,
                                                         smem);
  kernel<<<(prm.B + kSolveSamples - 1) / kSolveSamples, kSolveThreads, smem, stream>>>(prm);
  return cudaGetLastError();
}

// The solve kernel's tilings: FP in {16, 32, 64}, DP in {2, 4, 8}.
cudaError_t dispatch_solve(const SolveParams& prm, int fp, int dp, cudaStream_t stream,
                           int* blocks_per_sm) {
#define NF_SOLVE_TILING(FP_, DP_) \
  if (fp == FP_ && dp == DP_) return launch_solve<FP_, DP_>(prm, stream, blocks_per_sm);
  NF_SOLVE_TILING(16, 2)
  NF_SOLVE_TILING(16, 4)
  NF_SOLVE_TILING(16, 8)
  NF_SOLVE_TILING(32, 2)
  NF_SOLVE_TILING(32, 4)
  NF_SOLVE_TILING(32, 8)
  NF_SOLVE_TILING(64, 2)
  NF_SOLVE_TILING(64, 4)
  NF_SOLVE_TILING(64, 8)
#undef NF_SOLVE_TILING
  return cudaErrorInvalidValue;
}

// Launches the variant on `stream`, or with blocks_per_sm set only
// reports how many of its blocks one SM holds at once.
template <int FP, int DP, bool SOLVE, bool LOGDET>
cudaError_t launch(const Params& prm, cudaStream_t stream, int* blocks_per_sm) {
  const size_t smem = sizeof(float) * smem_floats<FP, DP>();
  auto kernel = fused_resflow_kernel<FP, DP, SOLVE, LOGDET>;
  static size_t opted_in = 48 * 1024;  // above 48 KB a block needs the opt-in
  if (smem > opted_in) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  if (blocks_per_sm != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kT, smem);
  kernel<<<(prm.B + kS - 1) / kS, kT, smem, stream>>>(prm);
  return cudaGetLastError();
}

template <int FP, int DP>
cudaError_t launch_variant(const Params& prm, int variant, cudaStream_t stream,
                           int* blocks_per_sm) {
  switch (variant) {
    case 0:  // up to FP = 64 the solve runs fused_resflow_solve_kernel
      if constexpr (FP >= 128) return launch<FP, DP, true, false>(prm, stream, blocks_per_sm);
      return cudaErrorInvalidValue;
    case 1: return launch<FP, DP, true, true>(prm, stream, blocks_per_sm);
    case 2: return launch<FP, DP, false, true>(prm, stream, blocks_per_sm);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t dispatch(const Params& prm, int fp, int dp, int variant, cudaStream_t stream,
                     int* blocks_per_sm) {
#define NF_TILING(FP_, DP_)  \
  if (fp == FP_ && dp == DP_) \
    return launch_variant<FP_, DP_>(prm, variant, stream, blocks_per_sm);
  NF_TILING(16, 2)
  NF_TILING(16, 4)
  NF_TILING(16, 8)
  NF_TILING(32, 2)
  NF_TILING(32, 4)
  NF_TILING(32, 8)
  NF_TILING(64, 2)
  NF_TILING(64, 4)
  NF_TILING(64, 8)
  NF_TILING(128, 2)
  NF_TILING(128, 4)
  NF_TILING(128, 8)
  NF_TILING(256, 2)
  NF_TILING(256, 4)
  NF_TILING(256, 8)
#undef NF_TILING
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point: launches one variant (0 solve, 1 solve_ld, 2 fwd_ld)
// on `stream` and returns the cudaError_t of the launch (0 on success).
// (fp, dp) must be one of the tilings below, as fused_resflow.py's
// padded_width / padded_dim choose them; n_terms is a host array of the
// 4 probes' series lengths and pairs the host array {a, d, b, c} of
// fused_resflow.py::probe_pairs (both read for the LOGDET variants).
extern "C" int nf_fused_resflow(const void* x, void* y, void* ld, const void* w, const void* v,
                                const int* n_terms, const int* pairs, int B, int n, int D,
                                int F, int fp, int dp, int n_iters, float ftol, int variant,
                                float ld_sign, float ld_const, void* stream) {
  if (D < 1 || D > dp || F < 1 || F > fp || n < 1 || n_iters < 1 || variant < 0 || variant > 2)
    return (int)cudaErrorInvalidValue;
  const bool logdet = variant != 0;
  if (logdet && (v == nullptr || ld == nullptr || n_terms == nullptr || pairs == nullptr))
    return (int)cudaErrorInvalidValue;
  Params prm{static_cast<const float*>(x), static_cast<float*>(y), static_cast<float*>(ld),
             static_cast<const float*>(w), static_cast<const float*>(v),
             {0, 0, 0, 0}, {{0, 1}, {2, 3}}, {}, B, n, D, n_iters, ftol, ld_sign, ld_const};
  // the same f32 operations as nf_tpu's roulette_coefficient: 2^e is exact
  for (int k = 1; k <= kMaxTerms; ++k)
    prm.coef[k] = ((k & 1) ? 1.f : -1.f) * ldexpf(1.f, k - kNExact - 1 > 0 ? k - kNExact - 1 : 0) /
                  (float)k;
  if (logdet) {
    bool seen[kProbes] = {false, false, false, false};
    for (int s = 0; s < kProbes; ++s) {
      prm.n_terms[s] = n_terms[s];
      if (n_terms[s] < 1 || n_terms[s] > kMaxTerms) return (int)cudaErrorInvalidValue;
      const int p = pairs[s];
      if (p < 0 || p >= kProbes || seen[p]) return (int)cudaErrorInvalidValue;
      seen[p] = true;
      prm.pair[s / 2][s % 2] = p;
    }
    for (int pi = 0; pi < 2; ++pi)
      if (n_terms[prm.pair[pi][0]] < n_terms[prm.pair[pi][1]]) return (int)cudaErrorInvalidValue;
  }
  return (int)dispatch(prm, fp, dp, variant, static_cast<cudaStream_t>(stream), nullptr);
}

// Blocks of the (fp, dp) tiling's variant that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, with the kernel's own
// threads and shared memory), into *blocks_per_sm.
extern "C" int nf_fused_resflow_blocks_per_sm(int fp, int dp, int variant, int* blocks_per_sm) {
  if (blocks_per_sm == nullptr) return (int)cudaErrorInvalidValue;
  return (int)dispatch(Params{}, fp, dp, variant, nullptr, blocks_per_sm);
}

// Plain C entry point of the warp-per-8-samples solve: z (B, D) -> x (B, D)
// on `stream`, returning the cudaError_t of the launch.  (fp, dp) one of
// its tilings (FP <= 64; fused_resflow.py::solve_kernel).
extern "C" int nf_fused_resflow_solve(const void* x, void* y, const void* w, int B, int n, int D,
                                      int F, int fp, int dp, int n_iters, float ftol,
                                      void* stream) {
  if (B < 1 || D < 1 || D > dp || F < 1 || F > fp || n < 1 || n_iters < 1)
    return (int)cudaErrorInvalidValue;
  const SolveParams prm{static_cast<const float*>(x), static_cast<float*>(y),
                        static_cast<const float*>(w), B, n, D, n_iters, ftol};
  return (int)dispatch_solve(prm, fp, dp, static_cast<cudaStream_t>(stream), nullptr);
}

// Blocks of the solve kernel's (fp, dp) tiling that one SM holds at once,
// into *blocks_per_sm.
extern "C" int nf_fused_resflow_solve_blocks_per_sm(int fp, int dp, int* blocks_per_sm) {
  if (blocks_per_sm == nullptr) return (int)cudaErrorInvalidValue;
  return (int)dispatch_solve(SolveParams{}, fp, dp, nullptr, blocks_per_sm);
}
