// Logistic-mixture CDF inverse with its fused log-det, Hopper (sm_90a).
//
// Replaces nf_tpu/ops/pallas/mixlogcdf.py::_bisect_kernel (launched by
// mix_log_cdf_inverse_pallas).  For y (B, N) and the mixture parameters
// logpi, mu, s (B, N, K), logpi log-softmaxed over K:
//   x[b, n] solves  sum_k pi_k sigmoid((x - mu_k) exp(-s_k)) = y[b, n]
//   ld[b]  = -sum_n logsumexp_k(logpi_k + z_k - s_k - 2 softplus(z_k)),
//            z_k = (x - mu_k) exp(-s_k)
// The solve is nf_tpu's bracket-safeguarded Newton (bijectors/
// mixlogcdf.py::_newton_solve) with its constants (SPAN, N_ITERS, XTOL,
// TINY): Newton in log-CDF space below the median and log-survival space
// above it, the midpoint where a proposal leaves the open bracket or fails
// the rtsafe step-halving test.  An element that is done never moves again
// (its x, and so its done test, stay the same), so its thread leaves the
// loop early with the same result as the fixed 24 trips.
//
// Bound (H100 SXM): each element reads 4 (1 + 3K) bytes and writes 4; each
// Newton evaluation costs K exps (one sigmoid per component) and one log
// on the SFUs and about 11K + 20 f32 operations, 4 to 8 evaluations per
// element on typical data.  At B = 1024, N = 512, K = 8 that is 52 MB
// (16 us at 3.35 TB/s) against several GFLOP: operations bound it.
//
// Design (a simple kernel first).
//  * One thread per element, its K (logpi, mu, s) and the derived pi and
//    exp(-s) loaded into registers once, at the padded count KP (8 or 32;
//    components k >= K skipped).  The TPU kernel's (B, K, N) sublane
//    transpose is not copied: in nf_tpu's (B, N, K) layout the K
//    parameters of one element are contiguous.
//  * One block per row: thread t takes elements t, t + blockDim, ...; the
//    row's log-det is each thread's sum in element order, then a warp
//    xor-butterfly and the warps' sums in warp order: a fixed order, no
//    float atomics, the same bits on every run.  At N = 512, K = 8 a block
//    is 512 threads, one element each.
//  * The CDF and pdf sums add the components in order, each product
//    rounded first (__fmul_rn / __fadd_rn: no fused multiply-add), as the
//    plain version (bijectors/mixlogcdf.py::_component_sum) does: near
//    y = 0 or 1 the root moves by the CDF's rounding over the pdf, so the
//    two solves agree only where they evaluate the CDF alike.
//  * Numerics: accurate expf / logf / log1pf and IEEE division.  Build
//    WITHOUT fast math: TINY = 1e-38 is an f32 subnormal that flush-to-zero
//    turns into 0, and fast math may drop the isfinite test.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>

namespace {

constexpr int kIters = 24;        // N_ITERS
constexpr float kSpan = 1.0e3f;   // SPAN
constexpr float kXtol = 1.0e-5f;  // XTOL
constexpr float kTiny = 1.0e-38f; // TINY (subnormal)
constexpr float kCdfMax = 1.0f - 1.0e-7f;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// torch.nn.functional.softplus (beta 1, threshold 20), as the plain version
__device__ __forceinline__ float softplus(float z) { return z > 20.f ? z : log1pf(expf(z)); }

template <int KP>
__device__ __forceinline__ float solve(float y, const float (&pi)[KP],
                                       const float (&inv)[KP], const float (&mu)[KP], int K) {
  const bool use_lo = y < 0.5f;
  const float ly = logf(fmaxf(y, kTiny));
  const float l1y = logf(fmaxf(1.f - y, kTiny));
  float x = 0.f, lo = -kSpan, hi = kSpan, dxold = 2.f * kSpan;
  for (int it = 0; it < kIters; ++it) {
    float cdf = 0.f, pdf = 0.f;
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      if (k < K) {
        const float sg = 1.f / (1.f + expf(-((x - mu[k]) * inv[k])));
        cdf = __fadd_rn(cdf, __fmul_rn(pi[k], sg));
        pdf = __fadd_rn(pdf, __fmul_rn(__fmul_rn(__fmul_rn(pi[k], inv[k]), sg), 1.f - sg));
      }
    }
    const float fraw = cdf - y;
    if (fraw < 0.f) lo = x;
    if (fraw >= 0.f) hi = x;
    const float c = fminf(fmaxf(cdf, kTiny), kCdfMax);
    const float f = use_lo ? logf(c) - ly : l1y - log1pf(-c);
    const float df = fmaxf(use_lo ? pdf / c : pdf / (1.f - c), kTiny);
    float dx = f / df;
    float xn = x - dx;
    const bool use_bis = xn <= lo || xn >= hi || fabsf(2.f * f) > fabsf(dxold * df) ||
                         !isfinite(xn);
    if (fabsf(dx) <= kXtol || (hi - lo) <= kXtol) break;  // converged: x freezes
    if (use_bis) {
      dx = (hi - lo) * 0.5f;
      xn = (lo + hi) * 0.5f;
    }
    x = xn;
    dxold = dx;
  }
  return x;
}

template <int KP>
__device__ __forceinline__ float mixture_logpdf(float x, const float (&logpi)[KP],
                                                const float (&inv)[KP], const float (&mu)[KP],
                                                const float (&s)[KP], int K) {
  float t[KP];
  float m = -INFINITY;
#pragma unroll
  for (int k = 0; k < KP; ++k) {
    if (k < K) {
      const float z = (x - mu[k]) * inv[k];
      t[k] = logpi[k] + ((z - s[k]) - 2.f * softplus(z));
      m = fmaxf(m, t[k]);
    }
  }
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < KP; ++k)
    if (k < K) sum += expf(t[k] - m);
  return logf(sum) + m;
}

// threads per block: one element each at KP = 8 and N <= 512; half as many
// at KP = 32, whose five register arrays of 32 take 160 registers a thread
__host__ __device__ constexpr int threads_for(int kp) { return kp <= 8 ? 512 : 256; }

template <int KP>
__global__ void __launch_bounds__(threads_for(KP))
    mix_inverse_kernel(const float* __restrict__ y, const float* __restrict__ logpi_g,
                       const float* __restrict__ mu_g, const float* __restrict__ s_g,
                       float* __restrict__ x_out, float* __restrict__ ld_out, int N, int K) {
  __shared__ float warp_sums[threads_for(KP) / 32];
  const size_t row = blockIdx.x;
  float acc = 0.f;
  for (int n = threadIdx.x; n < N; n += blockDim.x) {
    const size_t e = row * N + n;
    const float* lp = logpi_g + e * K;
    const float* mp = mu_g + e * K;
    const float* sp = s_g + e * K;
    float logpi[KP], mu[KP], s[KP], pi[KP], inv[KP];
#pragma unroll
    for (int k = 0; k < KP; ++k) {
      if (k < K) {
        logpi[k] = lp[k];
        mu[k] = mp[k];
        s[k] = sp[k];
        pi[k] = expf(logpi[k]);
        inv[k] = expf(-s[k]);
      }
    }
    const float x = solve<KP>(y[e], pi, inv, mu, K);
    x_out[e] = x;
    acc += mixture_logpdf<KP>(x, logpi, inv, mu, s, K);
  }
  acc = warp_sum(acc);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) total += warp_sums[w];
    ld_out[row] = -total;
  }
}

template <int KP>
cudaError_t launch(const float* y, const float* logpi, const float* mu, const float* s,
                   float* x, float* ld, int B, int N, int K, cudaStream_t st) {
  const int want = ((N + 31) / 32) * 32;
  const int threads = want < threads_for(KP) ? want : threads_for(KP);
  mix_inverse_kernel<KP><<<B, threads, 0, st>>>(y, logpi, mu, s, x, ld, N, K);
  return cudaGetLastError();
}

}  // namespace

// x (B, n) and ld (B,) from y (B, n) and contiguous (B, n, K) float32
// mixture tensors; KP in {8, 32}, K <= KP (the wrapper checks).  Returns
// cudaGetLastError() after the launch.
extern "C" int nf_mix_log_cdf_inverse(const void* y, const void* logpi, const void* mu,
                                      const void* s, void* x, void* ld, int B, int n, int K,
                                      int KP, void* stream) {
  if (B <= 0) return 0;
  if (n <= 0 || K <= 0 || K > KP) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* yf = static_cast<const float*>(y);
  const auto* lp = static_cast<const float*>(logpi);
  const auto* m = static_cast<const float*>(mu);
  const auto* sc = static_cast<const float*>(s);
  auto* xf = static_cast<float*>(x);
  auto* l = static_cast<float*>(ld);
  cudaError_t err;
  switch (KP) {
    case 8: err = launch<8>(yf, lp, m, sc, xf, l, B, n, K, st); break;
    case 32: err = launch<32>(yf, lp, m, sc, xf, l, B, n, K, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)err;
}
