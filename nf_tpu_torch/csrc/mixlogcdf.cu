// Logistic-mixture CDF inverse with its fused log-det, Hopper (sm_90a).
//
// Replaces nf_tpu/ops/pallas/mixlogcdf.py::_bisect_kernel (launched by
// mix_log_cdf_inverse_pallas).  For y (B, N) and the mixture parameters
// logpi, mu, s (B, N, K), logpi log-softmaxed over K, any K >= 1:
//   x[b, n] solves  sum_k pi_k sigmoid((x - mu_k) exp(-s_k)) = y[b, n]
//   ld[b]  = -sum_n logsumexp_k(logpi_k + z_k - s_k - 2 softplus(z_k)),
//            z_k = (x - mu_k) exp(-s_k)
// The solve is nf_tpu's bracket-safeguarded Newton (bijectors/
// mixlogcdf.py::_newton_solve) with its constants (SPAN, N_ITERS, XTOL,
// TINY): Newton in log-CDF space below the median and log-survival space
// above it, the midpoint where a proposal leaves the open bracket or fails
// the rtsafe step-halving test.  An element that is done never moves again
// (its x, and so its done test, stay the same), so it leaves the loop at
// its first done trip with the same result as the fixed 24 trips.
//
// Bound (H100 SXM): each element reads 4 (1 + 3K) bytes and writes 4; each
// Newton evaluation costs K exps (one sigmoid per component) and one log
// on the SFUs and about 11K + 20 f32 operations, 4 to 5 evaluations per
// element on typical data.  At B = 1024, N = 512, K = 8 the bytes take
// 16.3 us at 3.35 TB/s; the instructions of the evaluations, the set-up
// and the log-det take about as long again at the card's instruction
// rate, so instructions, not bytes, bound this design.
//
// Design.
//  * The arithmetic per element is the plain version's and stays so: the
//    CDF and pdf sums add the components in order, each product rounded
//    first (__fmul_rn / __fadd_rn: no fused multiply-add), as
//    bijectors/mixlogcdf.py::_component_sum does; accurate expf / logf /
//    log1pf and IEEE division.  Near y = 0 or 1 the root moves by the
//    CDF's rounding over the pdf, so the two solves agree only where they
//    evaluate the CDF alike.  Build WITHOUT fast math: TINY = 1e-38 is an
//    f32 subnormal that flush-to-zero turns into 0.
//  * Lane refill.  A block of 8 warps takes rows_per_block consecutive
//    rows (the wrapper picks it so the grid is about one wave), as one run
//    of elements; each warp takes a contiguous eighth of the run.  Its 32
//    lanes start on the first 32 elements, and a lane whose element is
//    done takes the next one of the warp's part at the next trip (ballot
//    and popc hand them out in lane order), so the warp's trips follow the
//    evaluations instead of each 32 elements' slowest one.
//  * Occupancy: 256-thread blocks with at most 64 registers a thread
//    (__launch_bounds__(256, 4)): 32 warps on an SM.  Only pi, exp(-s) and
//    mu of a lane's element are kept through its Newton trips (K <= 8), in
//    the lane's slot of shared memory (24 KB a block): in registers they
//    left too few for the Newton state around the IEEE divisions' slow-path
//    calls, which ptxas then spilled inside the trip loop.  K < 8 is padded
//    with components that add exact zeros, so the trips test no k.  logpi
//    and s are read again for the log-det.  Past K = 8 the
//    components are walked in chunks of 8, in k order, read from memory at
//    each evaluation, so the sums keep their sequential order for any K.
//  * Loads: the (B, N, K) tensors are read with 16-byte loads where K is a
//    multiple of 4 and the tensors are 16-byte aligned (two float4 per
//    tensor and element at K = 8), else with 4-byte loads.
//  * The log-det: a lane writes its element's x into shared memory; once
//    the block's warps are done, every thread takes elements t, t + 256,
//    ... of the run, writes x out and turns it into its log pdf, and each
//    row is summed by one warp in a fixed order (lane l the elements
//    l, l + 32, ... in turn, then an xor butterfly over the lanes), so
//    two launches give the same bits.  Rows longer than the run's room
//    (kChunk elements) are walked in pieces of kChunk, their sums added in
//    order.

#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kIters = 24;        // N_ITERS
constexpr float kSpan = 1.0e3f;   // SPAN
constexpr float kXtol = 1.0e-5f;  // XTOL
constexpr float kTiny = 1.0e-38f; // TINY (subnormal)
constexpr float kCdfMax = 1.0f - 1.0e-7f;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kMinBlocks = 4;     // blocks per SM: 32 warps
constexpr int kChunk = 2048;      // elements of a run in shared memory
constexpr int KC = 8;             // components per chunk in registers
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* y;      // (B, N)
  const float* logpi;  // (B, N, K)
  const float* mu;
  const float* s;
  float* x;            // (B, N)
  float* ld;           // (B,)
  int B, N, K, rows;   // rows: rows per block
  bool vec;            // 16-byte loads of the (B, N, K) tensors
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// torch.nn.functional.softplus (beta 1, threshold 20), as the plain version
__device__ __forceinline__ float softplus(float z) { return z > 20.f ? z : log1pf(expf(z)); }

// components k0 .. k0 + KC - 1 (those below K) of element e of a (B, N, K) tensor
__device__ __forceinline__ void load_chunk(const float* __restrict__ p, size_t e, int K, int k0,
                                           bool vec, float (&v)[KC]) {
  const float* q = p + e * K + k0;
#pragma unroll
  for (int k = 0; k < KC; ++k) v[k] = 0.f;
  if (vec) {
#pragma unroll
    for (int j = 0; j < KC / 4; ++j) {
      if (k0 + 4 * j < K) {
        const float4 f = __ldg(reinterpret_cast<const float4*>(q) + j);
        v[4 * j] = f.x;
        v[4 * j + 1] = f.y;
        v[4 * j + 2] = f.z;
        v[4 * j + 3] = f.w;
      }
    }
  } else {
#pragma unroll
    for (int k = 0; k < KC; ++k)
      if (k0 + k < K) v[k] = __ldg(q + k);
  }
}

// pi = exp(logpi), inv = exp(-s) and mu of components k0 .. k0 + KC - 1,
// each exp taken as its value arrives (no second array of raw values live)
__device__ __forceinline__ void load_mixture(const Params& p, size_t e, int k0, float (&pi)[KC],
                                             float (&inv)[KC], float (&mu)[KC]) {
  load_chunk(p.logpi, e, p.K, k0, p.vec, pi);
  load_chunk(p.s, e, p.K, k0, p.vec, inv);
  load_chunk(p.mu, e, p.K, k0, p.vec, mu);
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    if (k0 + k < p.K) {
      pi[k] = expf(pi[k]);
      inv[k] = expf(-inv[k]);
    }
  }
}

// cdf and pdf at x over components k0 .. k0 + KC - 1, added in order
__device__ __forceinline__ void mixture_sums(float x, int k0, int K, const float (&pi)[KC],
                                             const float (&inv)[KC], const float (&mu)[KC],
                                             float& cdf, float& pdf) {
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    if (k0 + k < K) {
      const float sg = 1.f / (1.f + expf(-((x - mu[k]) * inv[k])));
      cdf = __fadd_rn(cdf, __fmul_rn(pi[k], sg));
      pdf = __fadd_rn(pdf, __fmul_rn(__fmul_rn(__fmul_rn(pi[k], inv[k]), sg), 1.f - sg));
    }
  }
}

// A lane's staged mixture (K <= KC) in shared memory: float4 groups g of
// pi (g = 0, 1), exp(-s) (2, 3) and mu (4, 5), group g of thread t at
// staged[g * kThreads + t], so a warp's 16-byte reads are conflict-free.
// Components k >= K hold pi = 0, exp(-s) = 1, mu = 0: they add exact zeros
// to the CDF and pdf sums, so the trips need no guard on k.
constexpr int kGroups = 3 * KC / 4;

// element e's mixture into a lane's slot (see above), padded past K
__device__ __forceinline__ void stage_mixture(const Params& p, size_t e, float4* slot) {
  float pi[KC], inv[KC], mu[KC];
  load_mixture(p, e, 0, pi, inv, mu);
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    if (k >= p.K) {
      pi[k] = 0.f;
      inv[k] = 1.f;
    }
  }
#pragma unroll
  for (int j = 0; j < KC / 4; ++j) {
    slot[j * kThreads] = make_float4(pi[4 * j], pi[4 * j + 1], pi[4 * j + 2], pi[4 * j + 3]);
    slot[(2 + j) * kThreads] =
        make_float4(inv[4 * j], inv[4 * j + 1], inv[4 * j + 2], inv[4 * j + 3]);
    slot[(4 + j) * kThreads] = make_float4(mu[4 * j], mu[4 * j + 1], mu[4 * j + 2], mu[4 * j + 3]);
  }
}

// cdf and pdf at x from the lane's staged mixture, in component order
__device__ __forceinline__ void staged_sums(float x, const float4* slot, float& cdf, float& pdf) {
#pragma unroll
  for (int j = 0; j < KC / 4; ++j) {
    const float4 P = slot[j * kThreads], I = slot[(2 + j) * kThreads],
                 M = slot[(4 + j) * kThreads];
    const float pi[4] = {P.x, P.y, P.z, P.w}, inv[4] = {I.x, I.y, I.z, I.w},
                mu[4] = {M.x, M.y, M.z, M.w};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const float sg = 1.f / (1.f + expf(-((x - mu[q]) * inv[q])));
      cdf = __fadd_rn(cdf, __fmul_rn(pi[q], sg));
      pdf = __fadd_rn(pdf, __fmul_rn(__fmul_rn(__fmul_rn(pi[q], inv[q]), sg), 1.f - sg));
    }
  }
}

// log pdf of the mixture at x for element e: logsumexp over k, the
// components read in chunks (twice past K = KC: the maximum, then the sum)
__device__ __forceinline__ float mixture_logpdf(const Params& p, size_t e, float x) {
  float t[KC];
  float m = -INFINITY;
  for (int k0 = 0; k0 < p.K; k0 += KC) {
    float lp[KC], mu[KC], sc[KC];
    load_chunk(p.logpi, e, p.K, k0, p.vec, lp);
    load_chunk(p.mu, e, p.K, k0, p.vec, mu);
    load_chunk(p.s, e, p.K, k0, p.vec, sc);
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      if (k0 + k < p.K) {
        const float z = (x - mu[k]) * expf(-sc[k]);
        t[k] = lp[k] + ((z - sc[k]) - 2.f * softplus(z));
        m = fmaxf(m, t[k]);
      }
    }
  }
  float sum = 0.f;
  for (int k0 = 0; k0 < p.K; k0 += KC) {
    if (p.K > KC) {  // t[] holds the last chunk only: form this chunk's again
      float lp[KC], mu[KC], sc[KC];
      load_chunk(p.logpi, e, p.K, k0, p.vec, lp);
      load_chunk(p.mu, e, p.K, k0, p.vec, mu);
      load_chunk(p.s, e, p.K, k0, p.vec, sc);
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        if (k0 + k < p.K) {
          const float z = (x - mu[k]) * expf(-sc[k]);
          t[k] = lp[k] + ((z - sc[k]) - 2.f * softplus(z));
        }
      }
    }
#pragma unroll
    for (int k = 0; k < KC; ++k)
      if (k0 + k < p.K) sum += expf(t[k] - m);
  }
  return logf(sum) + m;
}

// The Newton solves of one warp's part [lo_e, hi_e) of the run that starts
// at element `base`, with lane refill; each element's x goes to xs[i], i
// its index in the run.  RESIDENT (K <= KC): the element's pi, exp(-s), mu
// are staged in the lane's slot; else they are read chunk by chunk at each
// evaluation.
template <bool RESIDENT>
__device__ __forceinline__ void solve_part(const Params& p, size_t base, int lo_e, int hi_e,
                                           float* xs, float4* slot, int lane) {
  const unsigned below = (1u << lane) - 1u;
  int next = lo_e;  // the part's next element to hand out (the same on every lane)
  int i = -1;       // this lane's element, -1 for none
  float y = 0.f, ly = 0.f, x = 0.f, lo = 0.f, hi = 0.f, dxold = 0.f;
  bool use_lo = false;
  int it = 0;
  while (true) {
    const bool need = i < 0;
    const unsigned want = __ballot_sync(kFull, need);
    const int rank = __popc(want & below);
    const int m = min(__popc(want), hi_e - next);  // elements handed out at this trip
    if (m > 0) {
      if (need && rank < m) {
        i = next + rank;
        if (RESIDENT) stage_mixture(p, base + i, slot);
        y = p.y[base + i];
        use_lo = y < 0.5f;
        ly = logf(fmaxf(use_lo ? y : 1.f - y, kTiny));  // log y, or log(1 - y)
        x = 0.f;
        lo = -kSpan;
        hi = kSpan;
        dxold = 2.f * kSpan;
        it = 0;
      }
      next += m;
    }
    if (!__any_sync(kFull, i >= 0)) break;
    if (i < 0) continue;
    // one trip of element i
    float cdf = 0.f, pdf = 0.f;
    if (RESIDENT) {
      staged_sums(x, slot, cdf, pdf);
    } else {
      for (int k0 = 0; k0 < p.K; k0 += KC) {
        float pi[KC], inv[KC], mu[KC];
        load_mixture(p, base + i, k0, pi, inv, mu);
        mixture_sums(x, k0, p.K, pi, inv, mu, cdf, pdf);
      }
    }
    const float fraw = cdf - y;
    if (fraw < 0.f) lo = x;
    if (fraw >= 0.f) hi = x;
    const float c = fminf(fmaxf(cdf, kTiny), kCdfMax);
    const float f = use_lo ? logf(c) - ly : ly - log1pf(-c);
    const float df = fmaxf(use_lo ? pdf / c : pdf / (1.f - c), kTiny);
    float dx = f / df;
    float xn = x - dx;
    const bool use_bis = xn <= lo || xn >= hi || fabsf(2.f * f) > fabsf(dxold * df) ||
                         !isfinite(xn);
    bool done = fabsf(dx) <= kXtol || (hi - lo) <= kXtol;  // converged: x freezes
    if (!done) {
      if (use_bis) {
        dx = (hi - lo) * 0.5f;
        xn = (lo + hi) * 0.5f;
      }
      x = xn;
      dxold = dx;
      done = ++it == kIters;
    }
    if (done) {
      xs[i] = x;
      i = -1;
    }
  }
}

template <bool RESIDENT>
__global__ void __launch_bounds__(kThreads, kMinBlocks) mix_inverse_kernel(const Params p) {
  __shared__ float xs[kChunk];    // the run's x, then its log pdf
  __shared__ float racc[kChunk];  // the block's row sums
  __shared__ float4 staged[RESIDENT ? kGroups * kThreads : 1];  // the lanes' mixtures
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.x * p.rows;
  const int rows = min(p.rows, p.B - row0);
  const size_t base = (size_t)row0 * p.N;
  const size_t total = (size_t)rows * p.N;
  // a run is the block's rows (rows * N <= kChunk), or a piece of its one row
  const int seg = min(p.N, kChunk);
  for (int r = threadIdx.x; r < rows; r += kThreads) racc[r] = 0.f;
  for (size_t c0 = 0; c0 < total; c0 += kChunk) {
    const int len = (int)min((size_t)kChunk, total - c0);
    const int part = (len + kWarps - 1) / kWarps;
    const int lo_e = min(len, warp * part);
    solve_part<RESIDENT>(p, base + c0, lo_e, min(len, lo_e + part), xs,
                         staged + (RESIDENT ? threadIdx.x : 0), lane);
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += kThreads) {
      const size_t e = base + c0 + i;
      const float xv = xs[i];
      p.x[e] = xv;
      xs[i] = mixture_logpdf(p, e, xv);
    }
    __syncthreads();
    for (int j = warp; j * seg < len; j += kWarps) {
      const int s1 = min(len, (j + 1) * seg);
      float v = 0.f;
      for (int i = j * seg + lane; i < s1; i += 32) v += xs[i];
      v = warp_sum(v);
      if (lane == 0) racc[p.N <= kChunk ? j : 0] += v;
    }
    __syncthreads();
  }
  for (int r = threadIdx.x; r < rows; r += kThreads) p.ld[row0 + r] = -racc[r];
}

template <bool RESIDENT>
cudaError_t info(int* registers, int* blocks_per_sm) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, mix_inverse_kernel<RESIDENT>);
  if (err != cudaSuccess) return err;
  *registers = attr.numRegs;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm,
                                                       mix_inverse_kernel<RESIDENT>, kThreads, 0);
}

}  // namespace

// x (B, N) and ld (B,) from y (B, N) and contiguous (B, N, K) float32
// mixture tensors, on `stream`; rows_per_block rows per block (at most
// max(1, 2048 / N)).  Returns cudaGetLastError() after the launch.
extern "C" int nf_mix_log_cdf_inverse(const void* y, const void* logpi, const void* mu,
                                      const void* s, void* x, void* ld, int B, int N, int K,
                                      int rows_per_block, void* stream) {
  if (B <= 0) return 0;
  const int most = N <= kChunk ? kChunk / N : 1;
  if (N <= 0 || K <= 0 || rows_per_block < 1 || rows_per_block > most)
    return (int)cudaErrorInvalidValue;
  const auto aligned = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 == 0; };
  const Params p{static_cast<const float*>(y), static_cast<const float*>(logpi),
                 static_cast<const float*>(mu), static_cast<const float*>(s),
                 static_cast<float*>(x), static_cast<float*>(ld), B, N, K, rows_per_block,
                 K % 4 == 0 && aligned(logpi) && aligned(mu) && aligned(s)};
  const int blocks = (B + rows_per_block - 1) / rows_per_block;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (K <= KC)
    mix_inverse_kernel<true><<<blocks, kThreads, 0, st>>>(p);
  else
    mix_inverse_kernel<false><<<blocks, kThreads, 0, st>>>(p);
  return (int)cudaGetLastError();
}

// Registers per thread and blocks per SM (occupancy API) of the kernel
// that K components take.
extern "C" int nf_mix_log_cdf_inverse_info(int K, int* registers, int* blocks_per_sm) {
  if (K <= 0 || registers == nullptr || blocks_per_sm == nullptr)
    return (int)cudaErrorInvalidValue;
  return (int)(K <= KC ? info<true>(registers, blocks_per_sm)
                       : info<false>(registers, blocks_per_sm));
}
