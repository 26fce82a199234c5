// Whole-stack eval kernel for the Flow++ 2-D density stack, Hopper (sm_90a).
//
// Replaces nf_tpu/ops/pallas/fused_flowpp.py::_make_kernels_flowpp
// (fwd_kernel / inv_kernel, launched by call_flowpp): the eval-mode forward
// or inverse of
//
//     n x [ ActNorm(2) -> logistic-mixture coupling with the MLP-attn conditioner ]
//
// in ONE launch.  Per coupling c (parity p = c & 1; z0 = row p, z1 = row 1-p):
//   forward:  x = (x - shift) * scale
//   h = w0 z1 + b0
//   u = W1 [elu(h); elu(-h)] + b1;  h += elu(u) * sigmoid(elu(-u))   (GatedLinear)
//   h = LayerNorm(h)
//   A = Wq h + bq;  y = Wo A + bo;  h += y[:F] * sigmoid(y[F:])       (attention at L = 1)
//   h = LayerNorm(h)
//   raw = Wh h + bh:  a = tanh(raw0) * g + b_g, b = raw1, logpi = log_softmax(K rows),
//                     mu (K rows), s (K rows)
//   u, v, logpdf = log CDF, log(1 - CDF), log pdf of the K-mixture at z0
//   forward:  z0 = (u - v) * exp(a) + b,  ld += (logpdf - u - v) + a
//   inverse:  t = (z0 - b) * exp(-a), ld -= a, z0 = Newton root of u - v = t,
//             ld -= logpdf - u - v at the root, then x = x / scale + shift
// The inverse walks c = n-1 .. 0.  The Newton solve is nf_tpu's
// bracket-safeguarded rtsafe in logit space with its constants (SPAN,
// N_ITERS, XTOL, TINY): 24 trips at most; an element that is done never
// moves again, so its lanes leave the loop early with the same result.
// ActNorm's constant log-det is folded on the host (pack_flowpp /
// kernel_weights in nf_tpu_torch/ops/cuda/fused_flowpp.py); ld starts at 0
// and ld_const is added at the end.
//
// Bound (H100 SXM): per sample and coupling F + 2F^2 + F^2 + 2F^2 + (2+3K)F
// multiply-adds (5,984 at F = 32, K = 8; 3.1 GFLOP per direction at
// B = 8192, n = 32, 0.047 ms at 67 TFLOP/s f32).  The inverse evaluates the
// mixture up to 25 times per coupling, each 5K + 3 transcendentals on the
// SFUs; on the main path's data an element needs 7.5 evaluations on
// average, and f32 operations bound both directions.  Weights (0.8 MB at
// n = 32) and x / y / logdet (0.1 MB) are far below HBM's rate.  What held
// the first design (one thread per sample, the TPU kernel's
// sample-per-lane layout) far from that bound was latency: at B = 8192 it
// ran 2 warps on each SM, each with 4 independent accumulators, and the
// inverse's warps waited on the slowest of 32 Newton solves.
//
// Design: a group of G = 8 lanes works on one sample.
//  * Blocks of 256 threads, 32 samples, share one staged copy of each
//    coupling's weights: B = 8192 is 256 blocks, 2,048 warps, about 15 on
//    each SM.  Each coupling's block is staged into shared memory with
//    cp.async, double-buffered one coupling ahead (the only block barrier
//    is one per coupling), its matrices' rows padded by 4 floats so that
//    the 8 lanes of a group, reading 8 rows at one column, meet no bank
//    conflicts.  Where two copies do not fit (F = 128, or F = 64 with
//    K > 8), the lanes read the block from global memory through L1 / L2.
//  * Dense layers split by output feature: lane j computes the outputs
//    o = j + i G, each dot product over the whole input in order, the
//    input read as float4 from the sample's row in shared memory (two
//    buffers, one written while the other is read, one __syncwarp per
//    layer).  The gated out-projection's value row o and gate row F + o
//    land in the same lane.
//  * Reductions by __shfl_xor_sync within the group, in a fixed butterfly
//    order (xor 1, 2, 4), each lane's partial first: the LayerNorm
//    statistics (only the F real features count), the head's log-softmax
//    and the mixture's three log-sum-exps.  Every lane ends with the same
//    bits, so the lanes of a group take the same Newton steps.
//  * Mixture components split across lanes: component k goes to lane
//    k mod G (a lane loops over KP / G of them).  The head's a and b rows
//    are computed by every lane of the group.
//  * The group runs each Newton trip together and leaves the loop together
//    when its sample is done: a warp waits on the slowest of its 4
//    samples, not of 32.  Lane 0 of the group writes the sample's y and
//    log-det.
//  * Widths: FP in {8, 16, 32, 64, 128} and KP in {8, 32}, zero-padded on
//    the host; padded features stay 0 through every layer, and mixture
//    components k >= K are skipped.
//  * Numerics: accurate expf / log1pf / logf / tanhf and IEEE division.
//    Build WITHOUT fast math: TINY = 1e-38 is an f32 subnormal that
//    flush-to-zero turns into 0, and fast math may drop the isfinite test.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kG = 8;                      // lanes per sample
constexpr int kThreads = 256;              // threads per block
constexpr int kSamples = kThreads / kG;    // samples per block
constexpr int kIters = 24;        // N_ITERS
constexpr float kSpan = 1.0e3f;   // SPAN
constexpr float kXtol = 1.0e-5f;  // XTOL
constexpr float kTiny = 1.0e-38f; // TINY (subnormal)
constexpr float kLnEps = 1.0e-5f;

struct Params {
  const float* x;    // (B, 2)
  float* y;          // (B, 2)
  float* ld;         // (B,)
  const float* w;    // (n, Layout::kSize) per-coupling weight blocks
  const float* pre;  // (n, 2, 2) forward (shift, scale) / inverse (shift, 1/scale)
  const float* gb;   // (n, 2)    (a_log_scale, a_bias)
  int B, n, F, K;
  float ld_const;
};

__host__ __device__ constexpr int align4(int v) { return (v + 3) & ~3; }

// One coupling's weight block in global memory, floats from its start;
// fused_flowpp.py's Layout mirrors this.
template <int FP, int KP>
struct Layout {
  static constexpr int kHP = align4(2 + 3 * KP);     // head rows
  static constexpr int kW1 = 0;                      // [FP][2FP]
  static constexpr int kWq = 2 * FP * FP;            // [FP][FP]
  static constexpr int kWo = 3 * FP * FP;            // [2FP][FP]
  static constexpr int kWh = 5 * FP * FP;            // [HP][FP]
  static constexpr int kVec = kWh + kHP * FP;        // w0 b0 b1 g1 be1 bq g2 be2
  static constexpr int kBo = kVec + 8 * FP;          // [2FP]
  static constexpr int kBh = kBo + 2 * FP;           // [HP]
  static constexpr int kSize = kBh + kHP;
};

// The block the kernel reads: Layout with each matrix row padded by kPad
// floats (4 when staged in shared memory, 0 when read from global memory).
template <int FP, int KP, bool STAGED>
struct SLayout {
  using L = Layout<FP, KP>;
  static constexpr int kPad = STAGED ? 4 : 0;
  static constexpr int kS1 = 2 * FP + kPad;          // W1's row stride
  static constexpr int kS = FP + kPad;               // Wq's, Wo's and Wh's
  static constexpr int kWq = FP * kS1;
  static constexpr int kWo = kWq + FP * kS;
  static constexpr int kWh = kWo + 2 * FP * kS;
  static constexpr int kVec = kWh + L::kHP * kS;
  static constexpr int kBo = kVec + 8 * FP;
  static constexpr int kBh = kBo + 2 * FP;
  static constexpr int kSize = kBh + L::kHP;

  // where float f of the global block lands (f a multiple of 4: rows are
  // multiples of 4 floats, so a 16-byte copy never crosses one)
  static __device__ __forceinline__ int at(int f) {
    if (f < L::kWq) {
      const int r = f / (2 * FP);
      return r * kS1 + (f - r * 2 * FP);
    }
    if (f < L::kVec) {  // Wq, Wo and Wh: consecutive rows of FP
      const int r = (f - L::kWq) / FP;
      return kWq + r * kS + (f - L::kWq - r * FP);
    }
    return kVec + (f - L::kVec);
  }
};

// a sample's row in shared memory: buffer A (2FP floats), buffer B (FP), and
// 4 floats of padding, so the 4 groups of a warp read other banks
template <int FP>
__host__ __device__ constexpr int row_floats() { return 3 * FP + 4; }

// shared floats of one block; fused_flowpp.py::smem_bytes mirrors this
template <int FP, int KP, bool STAGED>
constexpr int smem_floats() {
  return kSamples * row_floats<FP>() + (STAGED ? 2 * SLayout<FP, KP, true>::kSize : 0);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float elu(float x) { return x > 0.f ? x : expm1f(x); }

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// butterfly reductions over the group's 8 lanes: every lane gets the same bits
__device__ __forceinline__ float group_sum(float v, unsigned mask) {
  v += __shfl_xor_sync(mask, v, 1);
  v += __shfl_xor_sync(mask, v, 2);
  v += __shfl_xor_sync(mask, v, 4);
  return v;
}

__device__ __forceinline__ float group_max(float v, unsigned mask) {
  v = fmaxf(v, __shfl_xor_sync(mask, v, 1));
  v = fmaxf(v, __shfl_xor_sync(mask, v, 2));
  v = fmaxf(v, __shfl_xor_sync(mask, v, 4));
  return v;
}

// acc[i] = bias[rows[i]] + sum_k W[rows[i] * RS + k] in[k], k = 0 .. NIN - 1
// in order, the input from the sample's row in shared memory
template <int NIN, int NO, int RS>
__device__ __forceinline__ void dense(const float* W, const float* bias, const float* in,
                                      const int (&rows)[NO], float (&acc)[NO]) {
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = bias[rows[i]];
#pragma unroll 4
  for (int k = 0; k < NIN; k += 4) {
    const float4 x = ld4(in + k);
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      const float4 w = ld4(W + rows[i] * RS + k);
      acc[i] = fmaf(w.x, x.x, acc[i]);
      acc[i] = fmaf(w.y, x.y, acc[i]);
      acc[i] = fmaf(w.z, x.z, acc[i]);
      acc[i] = fmaf(w.w, x.w, acc[i]);
    }
  }
}

// this lane's NO outputs of an NO * G wide layer: o = j + i G
template <int NO>
__device__ __forceinline__ void lane_rows(int j, int (&rows)[NO]) {
#pragma unroll
  for (int i = 0; i < NO; ++i) rows[i] = j + i * kG;
}

// LayerNorm over the F real features; this lane holds features j + i G
template <int OPL>
__device__ __forceinline__ void layer_norm(float (&h)[OPL], const float* g, const float* b,
                                           int j, int F, unsigned mask) {
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < OPL; ++i) sum += h[i];  // padded features are 0
  const float mean = group_sum(sum, mask) / (float)F;
  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < OPL; ++i) {
    const float d = h[i] - mean;
    if (j + i * kG < F) sq = fmaf(d, d, sq);
  }
  const float rstd = rsqrtf(group_sum(sq, mask) / (float)F + kLnEps);
#pragma unroll
  for (int i = 0; i < OPL; ++i) {
    const int o = j + i * kG;
    h[i] = (h[i] - mean) * rstd * g[o] + b[o];
  }
}

template <int OPL>
__device__ __forceinline__ void store_row(float* row, const float (&h)[OPL], int j) {
#pragma unroll
  for (int i = 0; i < OPL; ++i) row[j + i * kG] = h[i];
}

// The conditioner: z1 -> the head's raw outputs of this lane: a, b, then
// logpi, mu and s of its KP / G components k = j + c G.
template <int FP, int KP, bool STAGED>
__device__ __forceinline__ void conditioner(const float* wc, float z1, float* bufA,
                                            float* bufB, int j, int F, unsigned mask,
                                            float (&raw)[2 + 3 * (KP / kG)]) {
  using SL = SLayout<FP, KP, STAGED>;
  constexpr int OPL = FP / kG, KPL = KP / kG;
  const float* vec = wc + SL::kVec;
  int rows[OPL], rows2[2 * OPL];
  lane_rows<OPL>(j, rows);
  lane_rows<2 * OPL>(j, rows2);
  float h[OPL];
#pragma unroll
  for (int i = 0; i < OPL; ++i) h[i] = fmaf(vec[rows[i]], z1, vec[FP + rows[i]]);

  {  // GatedLinear: [elu(h); elu(-h)] into A
#pragma unroll
    for (int i = 0; i < OPL; ++i) {
      bufA[rows[i]] = elu(h[i]);
      bufA[FP + rows[i]] = elu(-h[i]);
    }
    __syncwarp(mask);
    float u[OPL];
    dense<2 * FP, OPL, SL::kS1>(wc, vec + 2 * FP, bufA, rows, u);
#pragma unroll
    for (int i = 0; i < OPL; ++i) h[i] += elu(u[i]) * sigmoid(elu(-u[i]));
  }
  layer_norm<OPL>(h, vec + 3 * FP, vec + 4 * FP, j, F, mask);
  store_row<OPL>(bufB, h, j);
  __syncwarp(mask);

  {  // attention at one token: A = Wq h + bq into A, then the gated out-projection
    float A[OPL];
    dense<FP, OPL, SL::kS>(wc + SL::kWq, vec + 5 * FP, bufB, rows, A);
    store_row<OPL>(bufA, A, j);
    __syncwarp(mask);
    float y[2 * OPL];  // value rows j + i G, then gate rows F + j + i G
    dense<FP, 2 * OPL, SL::kS>(wc + SL::kWo, wc + SL::kBo, bufA, rows2, y);
#pragma unroll
    for (int i = 0; i < OPL; ++i) h[i] += y[i] * sigmoid(y[OPL + i]);
  }
  layer_norm<OPL>(h, vec + 6 * FP, vec + 7 * FP, j, F, mask);
  store_row<OPL>(bufB, h, j);
  __syncwarp(mask);

  int head[2 + 3 * KPL];
  head[0] = 0;
  head[1] = 1;
#pragma unroll
  for (int c = 0; c < KPL; ++c) {
    const int k = j + c * kG;
    head[2 + c] = 2 + k;
    head[2 + KPL + c] = 2 + KP + k;
    head[2 + 2 * KPL + c] = 2 + 2 * KP + k;
  }
  dense<FP, 2 + 3 * KPL, SL::kS>(wc + SL::kWh, wc + SL::kBh, bufB, head, raw);
}

struct Parts {
  float u, v, lpdf;  // log CDF, log(1 - CDF), log pdf
};

// The K-mixture's parts at x, this lane's components first, then the
// group's butterfly; in the stable forms: with t = log1p(exp(-|z|)),
// log_sigmoid(z) = min(z, 0) - t, log_sigmoid(-z) = -max(z, 0) - t and
// softplus(z) = max(z, 0) + t.
template <int KPL>
__device__ __forceinline__ Parts mix_parts(float x, const float (&lp)[KPL],
                                           const float (&mu)[KPL], const float (&is)[KPL],
                                           const float (&s)[KPL], int j, int K,
                                           unsigned mask) {
  float tu[KPL], tv[KPL], tp[KPL];
  float mu_max = -INFINITY, mv_max = -INFINITY, mp_max = -INFINITY;
#pragma unroll
  for (int c = 0; c < KPL; ++c) {
    if (j + c * kG < K) {
      const float z = (x - mu[c]) * is[c];
      const float t = log1pf(expf(-fabsf(z)));
      tu[c] = lp[c] + (fminf(z, 0.f) - t);
      tv[c] = lp[c] + (-fmaxf(z, 0.f) - t);
      tp[c] = lp[c] + (z - s[c] - 2.f * (fmaxf(z, 0.f) + t));
      mu_max = fmaxf(mu_max, tu[c]);
      mv_max = fmaxf(mv_max, tv[c]);
      mp_max = fmaxf(mp_max, tp[c]);
    }
  }
  mu_max = group_max(mu_max, mask);
  mv_max = group_max(mv_max, mask);
  mp_max = group_max(mp_max, mask);
  float su = 0.f, sv = 0.f, sp = 0.f;
#pragma unroll
  for (int c = 0; c < KPL; ++c) {
    if (j + c * kG < K) {
      su += expf(tu[c] - mu_max);
      sv += expf(tv[c] - mv_max);
      sp += expf(tp[c] - mp_max);
    }
  }
  return Parts{mu_max + logf(group_sum(su, mask)), mv_max + logf(group_sum(sv, mask)),
               mp_max + logf(group_sum(sp, mask))};
}

template <int FP, int KP, bool INV, bool STAGED>
__global__ void __launch_bounds__(kThreads) fused_flowpp_kernel(const Params prm) {
  using L = Layout<FP, KP>;
  using SL = SLayout<FP, KP, STAGED>;
  constexpr int KPL = KP / kG;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int grp = tid / kG, j = tid % kG;
  const unsigned mask = 0xffu << ((tid & 31) & ~(kG - 1));  // the group's lanes
  float* bufA = smem + grp * row_floats<FP>();
  float* bufB = bufA + 2 * FP;
  float* buf = smem + kSamples * row_floats<FP>();  // 2 x SL::kSize when STAGED
  const int sample = blockIdx.x * kSamples + grp;
  const int K = prm.K;

  auto coupling = [&](int step) { return INV ? prm.n - 1 - step : step; };
  auto stage = [&](int step) {
    const float* src = prm.w + (size_t)coupling(step) * L::kSize;
    float* dst = buf + (step & 1) * SL::kSize;
    for (int i = tid; i < L::kSize / 4; i += kThreads)
      __pipeline_memcpy_async(dst + SL::at(4 * i), src + 4 * i, 16);
  };

  if (STAGED) {
    stage(0);
    __pipeline_commit();
  }
  float x0 = 0.f, x1 = 0.f;
  if (sample < prm.B) {
    const float2 q = *reinterpret_cast<const float2*>(prm.x + 2 * (size_t)sample);
    x0 = q.x;
    x1 = q.y;
  }
  float ld = 0.f;

  for (int step = 0; step < prm.n; ++step) {
    const int c = coupling(step), p = c & 1;
    const float* wc;
    if (STAGED) {
      // coupling `step` has landed and everyone is done with step - 1,
      // whose slot the next coupling now fills
      __pipeline_wait_prior(0);
      __syncthreads();
      if (step + 1 < prm.n) stage(step + 1);
      __pipeline_commit();
      wc = buf + (step & 1) * SL::kSize;
    } else {
      wc = prm.w + (size_t)c * L::kSize;
    }
    const float4 pr = *reinterpret_cast<const float4*>(prm.pre + 4 * (size_t)c);
    if (!INV) {
      x0 = (x0 - pr.x) * pr.y;
      x1 = (x1 - pr.z) * pr.w;
    }
    const float z0 = p ? x1 : x0;
    float raw[2 + 3 * KPL];
    conditioner<FP, KP, STAGED>(wc, p ? x0 : x1, bufA, bufB, j, prm.F, mask, raw);

    // head: a, b, log_softmax(logpi), mu, s of this lane's components
    const float a = tanhf(raw[0]) * prm.gb[2 * c] + prm.gb[2 * c + 1];
    const float b = raw[1];
    float lp[KPL], mu[KPL], s[KPL], is[KPL];
    float lmax = -INFINITY;
#pragma unroll
    for (int q = 0; q < KPL; ++q) {
      lp[q] = j + q * kG < K ? raw[2 + q] : -INFINITY;
      mu[q] = raw[2 + KPL + q];
      s[q] = raw[2 + 2 * KPL + q];
      is[q] = expf(-s[q]);
      lmax = fmaxf(lmax, lp[q]);
    }
    lmax = group_max(lmax, mask);
    float lsum = 0.f;
#pragma unroll
    for (int q = 0; q < KPL; ++q)
      if (j + q * kG < K) lsum += expf(lp[q] - lmax);
    const float lse = lmax + logf(group_sum(lsum, mask));
#pragma unroll
    for (int q = 0; q < KPL; ++q) lp[q] -= lse;

    float z;
    if (!INV) {
      const Parts m = mix_parts<KPL>(z0, lp, mu, is, s, j, K, mask);
      z = (m.u - m.v) * expf(a) + b;
      ld += (m.lpdf - m.u - m.v) + a;
    } else {
      const float t = (z0 - b) * expf(-a);
      ld -= a;
      float xk = 0.f, lo = -kSpan, hi = kSpan, dxold = 2.f * kSpan;
      Parts m;
      bool fresh = false;  // m holds the parts at the final xk
      // the group's lanes hold the same values, so they take the same
      // branches and leave together
      for (int it = 0; it < kIters; ++it) {
        m = mix_parts<KPL>(xk, lp, mu, is, s, j, K, mask);
        const float f = (m.u - m.v) - t;
        if (f < 0.f) lo = xk;
        if (f >= 0.f) hi = xk;
        const float df = fmaxf(expf(m.lpdf - m.u - m.v), kTiny);
        float dx = f / df;
        float xn = xk - dx;
        const bool use_bis = (xn <= lo) || (xn >= hi) || (fabsf(2.f * f) > fabsf(dxold * df)) ||
                             !isfinite(xn);
        if ((fabsf(dx) <= kXtol) || ((hi - lo) <= kXtol)) {
          fresh = true;  // frozen from here on: nf_tpu's later trips keep xk
          break;
        }
        if (use_bis) {
          dx = (hi - lo) * 0.5f;
          xn = (lo + hi) * 0.5f;
        }
        xk = xn;
        dxold = dx;
      }
      if (!fresh) m = mix_parts<KPL>(xk, lp, mu, is, s, j, K, mask);
      ld -= m.lpdf - m.u - m.v;
      z = xk;
    }
    if (p) x1 = z; else x0 = z;
    if (INV) {
      x0 = x0 * pr.y + pr.x;
      x1 = x1 * pr.w + pr.z;
    }
  }

  if (sample < prm.B && j == 0) {
    *reinterpret_cast<float2*>(prm.y + 2 * (size_t)sample) = make_float2(x0, x1);
    prm.ld[sample] = ld + prm.ld_const;
  }
}

template <int FP, int KP, bool INV, bool STAGED>
cudaError_t launch(const Params& prm, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats<FP, KP, STAGED>();
  auto kernel = fused_flowpp_kernel<FP, KP, INV, STAGED>;
  static size_t opted_in = 48 * 1024;  // above 48 KB a block needs the opt-in
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  kernel<<<(prm.B + kSamples - 1) / kSamples, kThreads, smem, stream>>>(prm);
  return cudaGetLastError();
}

template <int FP, int KP, bool STAGED>
cudaError_t launch_dir(const Params& prm, bool inverse, cudaStream_t stream) {
  return inverse ? launch<FP, KP, true, STAGED>(prm, stream)
                 : launch<FP, KP, false, STAGED>(prm, stream);
}

}  // namespace

// Plain C entry point: launches one direction on `stream` and returns the
// cudaError_t of the launch (0 on success).  (fp, kp, staged) must be one of
// the tilings below, as fused_flowpp.py's padded_width / padded_mixtures /
// staged choose them.
extern "C" int nf_fused_flowpp(const void* x, void* y, void* ld, const void* w,
                               const void* pre, const void* gb, int B, int n, int F,
                               int K, int fp, int kp, int staged, int inverse,
                               float ld_const, void* stream) {
  if (F < 1 || F > fp || K < 1 || K > kp) return (int)cudaErrorInvalidValue;
  const Params prm{static_cast<const float*>(x), static_cast<float*>(y),
                   static_cast<float*>(ld), static_cast<const float*>(w),
                   static_cast<const float*>(pre), static_cast<const float*>(gb),
                   B, n, F, K, ld_const};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool inv = inverse != 0;
#define NF_TILING(FP_, KP_, STAGED_)                     \
  if (fp == FP_ && kp == KP_ && (staged != 0) == STAGED_) \
    return (int)launch_dir<FP_, KP_, STAGED_>(prm, inv, st);
  NF_TILING(8, 8, true)
  NF_TILING(8, 32, true)
  NF_TILING(16, 8, true)
  NF_TILING(16, 32, true)
  NF_TILING(32, 8, true)
  NF_TILING(32, 32, true)
  NF_TILING(64, 8, true)
  NF_TILING(64, 32, false)
  NF_TILING(128, 8, false)
  NF_TILING(128, 32, false)
#undef NF_TILING
  return (int)cudaErrorInvalidValue;
}
