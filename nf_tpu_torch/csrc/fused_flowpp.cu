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
// moves again, so its thread leaves the loop early with the same result.
// ActNorm's constant log-det is folded on the host (pack_flowpp /
// kernel_weights in nf_tpu_torch/ops/cuda/fused_flowpp.py); ld starts at 0
// and ld_const is added at the end.
//
// Bound (H100 SXM): per sample and coupling F + 2F^2 + F^2 + 2F^2 + (2+3K)F
// multiply-adds (5,984 at F = 32, K = 8; 3.1 GFLOP per direction at
// B = 8192, n = 32, 0.047 ms at 67 TFLOP/s f32).  The inverse evaluates the
// mixture up to 25 times per coupling, each 5K + 3 transcendentals (exp and
// log1p per component, the three log-sum-exps' exp per component and their
// log) on the SFUs, 16 results per SM per clock.  On the main path's data
// an element needs 7.5 evaluations on average, and f32 operations bound
// both directions; the SFUs would pass them only if every element ran all
// 25.  Weights (0.8 MB at n = 32) and x / y / logdet (0.1 MB) are far below
// HBM's rate.
//
// Design (a simple kernel first).
//  * One thread per sample for the whole walk: the conditioner's vectors
//    (h, [elu(h); elu(-h)], A) live in registers at the padded width FP, so
//    both LayerNorms and the mixture's log-sum-exps are reductions inside
//    one thread, and the Newton loop's divergence costs only the warp's
//    slowest lane.  A block is 64 samples (2 warps); B = 8192 is 128 blocks,
//    one per SM.
//  * Each dense layer loops over its outputs four at a time: four
//    accumulators, one float4 weight load per four multiply-adds, the
//    inputs from registers.  A layer's outputs go to the thread's own
//    column of a shared-memory scratch (stride 64 floats: no bank
//    conflicts, no barrier) and come back into registers, so no register
//    array is indexed at run time.
//  * Weights: one coupling is one contiguous block (25 KB at F = 32,
//    K = 8), staged into shared memory by the whole block with cp.async,
//    double-buffered one coupling ahead; the only barrier is one per
//    coupling.  Where two blocks do not fit (F = 128, or F = 64 with
//    K > 8), the threads read the block straight from global memory:
//    every lane of a warp reads the same address, served by L1 / L2.
//  * Widths: FP in {8, 16, 32, 64, 128} and KP in {8, 32}, zero-padded on
//    the host; the LayerNorm statistics count only the F real features,
//    and mixture components k >= K are skipped.
//  * Numerics: accurate expf / log1pf / logf / tanhf and IEEE division.
//    Build WITHOUT fast math: TINY = 1e-38 is an f32 subnormal that
//    flush-to-zero turns into 0, and fast math may drop the isfinite test.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;            // threads per block, one sample each
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

// One coupling's weight block, floats from its start; fused_flowpp.py's
// Layout mirrors this.
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
  static constexpr int kScratch = FP > kHP ? FP : kHP;
};

// shared floats of one block; fused_flowpp.py::smem_bytes mirrors this
template <int FP, int KP, bool STAGED>
constexpr int smem_floats() {
  return Layout<FP, KP>::kScratch * kT + (STAGED ? 2 * Layout<FP, KP>::kSize : 0);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float elu(float x) { return x > 0.f ? x : expm1f(x); }

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

// acc[j] += sum_k W[j * NIN + k] * in[k], j < 4: four rows of a row-major
// (out, NIN) weight against register inputs
template <int NIN>
__device__ __forceinline__ void dot4(const float* W, const float (&in)[NIN],
                                     float (&acc)[4]) {
#pragma unroll
  for (int k = 0; k < NIN; k += 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float4 w = ld4(W + j * NIN + k);
      acc[j] = fmaf(w.x, in[k], acc[j]);
      acc[j] = fmaf(w.y, in[k + 1], acc[j]);
      acc[j] = fmaf(w.z, in[k + 2], acc[j]);
      acc[j] = fmaf(w.w, in[k + 3], acc[j]);
    }
  }
}

__device__ __forceinline__ void load_bias(float (&acc)[4], const float* b) {
  const float4 q = ld4(b);
  acc[0] = q.x; acc[1] = q.y; acc[2] = q.z; acc[3] = q.w;
}

// LayerNorm over the F real features of h (padded features are 0 and stay 0)
template <int FP>
__device__ __forceinline__ void layer_norm(float (&h)[FP], const float* g, const float* b,
                                           int F) {
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < FP; ++k) sum += h[k];
  const float mean = sum / (float)F;
  float sq = 0.f;
#pragma unroll
  for (int k = 0; k < FP; ++k) {
    const float d = h[k] - mean;
    if (k < F) sq = fmaf(d, d, sq);
  }
  const float rstd = rsqrtf(sq / (float)F + kLnEps);
#pragma unroll
  for (int k = 0; k < FP; ++k) h[k] = (h[k] - mean) * rstd * g[k] + b[k];
}

// The conditioner: z1 -> the head's raw outputs in this thread's scratch
// column sc[o * kT], o < HP.
template <int FP, int KP>
__device__ __forceinline__ void conditioner(const float* wc, float z1, float* sc, int F) {
  using L = Layout<FP, KP>;
  const float* vec = wc + L::kVec;
  float h[FP];
#pragma unroll
  for (int k = 0; k < FP; ++k) h[k] = fmaf(vec[k], z1, vec[FP + k]);

  {  // GatedLinear
    float e[2 * FP];
#pragma unroll
    for (int k = 0; k < FP; ++k) {
      e[k] = elu(h[k]);
      e[FP + k] = elu(-h[k]);
    }
#pragma unroll 1
    for (int o = 0; o < FP; o += 4) {
      float acc[4];
      load_bias(acc, vec + 2 * FP + o);
      dot4<2 * FP>(wc + L::kW1 + o * 2 * FP, e, acc);
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[(o + j) * kT] = elu(acc[j]) * sigmoid(elu(-acc[j]));
    }
#pragma unroll
    for (int k = 0; k < FP; ++k) h[k] += sc[k * kT];
  }
  layer_norm<FP>(h, vec + 3 * FP, vec + 4 * FP, F);

  {  // attention at one token: A = Wq h + bq, then the gated out-projection
    float A[FP];
#pragma unroll 1
    for (int o = 0; o < FP; o += 4) {
      float acc[4];
      load_bias(acc, vec + 5 * FP + o);
      dot4<FP>(wc + L::kWq + o * FP, h, acc);
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[(o + j) * kT] = acc[j];
    }
#pragma unroll
    for (int k = 0; k < FP; ++k) A[k] = sc[k * kT];
#pragma unroll 1
    for (int o = 0; o < FP; o += 4) {
      float yv[4], yg[4];
      load_bias(yv, wc + L::kBo + o);
      load_bias(yg, wc + L::kBo + FP + o);
      dot4<FP>(wc + L::kWo + o * FP, A, yv);
      dot4<FP>(wc + L::kWo + (FP + o) * FP, A, yg);
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[(o + j) * kT] = yv[j] * sigmoid(yg[j]);
    }
#pragma unroll
    for (int k = 0; k < FP; ++k) h[k] += sc[k * kT];
  }
  layer_norm<FP>(h, vec + 6 * FP, vec + 7 * FP, F);

#pragma unroll 1
  for (int o = 0; o < L::kHP; o += 4) {  // head
    float acc[4];
    load_bias(acc, wc + L::kBh + o);
    dot4<FP>(wc + L::kWh + o * FP, h, acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[(o + j) * kT] = acc[j];
  }
}

struct Parts {
  float u, v, lpdf;  // log CDF, log(1 - CDF), log pdf
};

// The K-mixture's parts at x, in the stable forms: with t = log1p(exp(-|z|)),
// log_sigmoid(z) = min(z, 0) - t, log_sigmoid(-z) = -max(z, 0) - t and
// softplus(z) = max(z, 0) + t.
template <int KP>
__device__ __forceinline__ Parts mix_parts(float x, const float (&lp)[KP], const float (&mu)[KP],
                                           const float (&is)[KP], const float (&s)[KP], int K) {
  float tu[KP], tv[KP], tp[KP];
  float mu_max = -INFINITY, mv_max = -INFINITY, mp_max = -INFINITY;
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    if (k < K) {
      const float z = (x - mu[k]) * is[k];
      const float t = log1pf(expf(-fabsf(z)));
      tu[k] = lp[k] + (fminf(z, 0.f) - t);
      tv[k] = lp[k] + (-fmaxf(z, 0.f) - t);
      tp[k] = lp[k] + (z - s[k] - 2.f * (fmaxf(z, 0.f) + t));
      mu_max = fmaxf(mu_max, tu[k]);
      mv_max = fmaxf(mv_max, tv[k]);
      mp_max = fmaxf(mp_max, tp[k]);
    }
  }
  float su = 0.f, sv = 0.f, sp = 0.f;
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    if (k < K) {
      su += expf(tu[k] - mu_max);
      sv += expf(tv[k] - mv_max);
      sp += expf(tp[k] - mp_max);
    }
  }
  return Parts{mu_max + logf(su), mv_max + logf(sv), mp_max + logf(sp)};
}

template <int FP, int KP, bool INV, bool STAGED>
__global__ void __launch_bounds__(kT) fused_flowpp_kernel(const Params prm) {
  using L = Layout<FP, KP>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  float* sc = smem + tid;                     // this thread's scratch column
  float* buf = smem + L::kScratch * kT;       // 2 x kSize when STAGED
  const int sample = blockIdx.x * kT + tid;
  const int K = prm.K;

  auto coupling = [&](int step) { return INV ? prm.n - 1 - step : step; };
  auto stage = [&](int step) {
    const float* src = prm.w + (size_t)coupling(step) * L::kSize;
    float* dst = buf + (step & 1) * L::kSize;
    for (int i = tid; i < L::kSize / 4; i += kT)
      __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
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
      wc = buf + (step & 1) * L::kSize;
    } else {
      wc = prm.w + (size_t)c * L::kSize;
    }
    const float4 pr = *reinterpret_cast<const float4*>(prm.pre + 4 * (size_t)c);
    if (!INV) {
      x0 = (x0 - pr.x) * pr.y;
      x1 = (x1 - pr.z) * pr.w;
    }
    const float z0 = p ? x1 : x0;
    conditioner<FP, KP>(wc, p ? x0 : x1, sc, prm.F);

    // head: a, b, log_softmax(logpi), mu, s
    const float a = tanhf(sc[0]) * prm.gb[2 * c] + prm.gb[2 * c + 1];
    const float b = sc[kT];
    float lp[KP], mu[KP], s[KP], is[KP];
    float lmax = -INFINITY;
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      lp[k] = k < K ? sc[(2 + k) * kT] : -INFINITY;
      mu[k] = sc[(2 + KP + k) * kT];
      s[k] = sc[(2 + 2 * KP + k) * kT];
      is[k] = expf(-s[k]);
      lmax = fmaxf(lmax, lp[k]);
    }
    float lsum = 0.f;
#pragma unroll
    for (int k = 0; k < KP; ++k)
      if (k < K) lsum += expf(lp[k] - lmax);
    const float lse = lmax + logf(lsum);
#pragma unroll
    for (int k = 0; k < KP; ++k) lp[k] -= lse;

    float z;
    if (!INV) {
      const Parts m = mix_parts<KP>(z0, lp, mu, is, s, K);
      z = (m.u - m.v) * expf(a) + b;
      ld += (m.lpdf - m.u - m.v) + a;
    } else {
      const float t = (z0 - b) * expf(-a);
      ld -= a;
      float xk = 0.f, lo = -kSpan, hi = kSpan, dxold = 2.f * kSpan;
      Parts m;
      bool fresh = false;  // m holds the parts at the final xk
      for (int it = 0; it < kIters; ++it) {
        m = mix_parts<KP>(xk, lp, mu, is, s, K);
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
      if (!fresh) m = mix_parts<KP>(xk, lp, mu, is, s, K);
      ld -= m.lpdf - m.u - m.v;
      z = xk;
    }
    if (p) x1 = z; else x0 = z;
    if (INV) {
      x0 = x0 * pr.y + pr.x;
      x1 = x1 * pr.w + pr.z;
    }
  }

  if (sample < prm.B) {
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
  kernel<<<(prm.B + kT - 1) / kT, kT, smem, stream>>>(prm);
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
