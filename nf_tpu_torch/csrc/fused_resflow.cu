// Whole-stack eval kernels for the ResFlow 1-D density stack, Hopper (sm_90a).
//
// Replaces the three Pallas kernels of nf_tpu/ops/pallas/fused_resflow.py,
// one template variant each (SOLVE, LOGDET):
//   solve     (true,  false)  make_solve_kernel        (call_solve)
//   solve_ld  (true,  true)   make_solve_logdet_kernel (call_solve_logdet)
//   fwd_ld    (false, true)   make_fwd_logdet_kernel   (call_fwd_logdet)
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
// and block the forward does 1 evaluation and sum_s n_terms products (40 at
// the zoo's probes), the inverse the solve's it + 1 evaluations (4-5) and the
// same products: about 2.5e10 flop per direction at B = 8192, n = 32, 0.37 ms
// at 67 TFLOP/s f32.  Weights (0.3 MB at n = 32) and x / z / probes / logdet
// (0.4 MB) are read or written once: f32 operations bound the kernel.
//
// Design.
//  * A block has 4 warps, one per probe, over a tile of 32 C samples: lane l
//    of warp p owns the (sample, probe p) columns of samples l, l + 32, ...,
//    C of them.  C = 2 where the series runs (F <= 32): each weight a thread
//    loads then feeds both columns, and their independent chains give twice
//    the instruction-level parallelism; at B = 8192 that is 128 blocks of 4
//    warps.  C = 1 for the solve alone (and F >= 64, where two columns' t no
//    longer fit in registers): 256 blocks, two per SM, overlap each other's
//    barriers.  On an H100 (chip_smoke.py, B = 8192, n = 32, F = 32) the
//    series variants took 2.79 / 3.07 ms with C = 1 and 1.37 / 1.75 ms with
//    C = 2; the solve alone ran slower with C = 2, on half the blocks.
//  * The series is the work and a chain of dependent products: each thread
//    runs its own columns, with no barrier inside the loop.  A warp runs its
//    own probe's n_terms (warp-uniform), not the cap.  The F x F product
//    W2 t runs four output rows at a time from register inputs, its weights
//    read as float4 broadcasts (every lane the same address), four
//    multiply-adds per load and column: up to FP = 64 along W2's rows (a
//    transposed copy of W2t in the weight block), at FP = 128, where the
//    copy does not fit, down W2t's columns (W2[o..o+3][k] = W2t[k][o..o+3]).
//    Each output is folded at once into W1 (D1 .): the product's outputs
//    are never stored.
//  * g's evaluations (the solve, the masks) are per sample and shared by the
//    4 probes: the 4 warps split the F hidden features, h1 / h2 and the masks
//    D1 / D2 go to shared memory [F][32 C] (lane-consecutive: no bank
//    conflicts), two barriers per evaluation; every thread then forms g's D
//    outputs itself, so all four warps hold the tile's x.
//  * Stopping is per block (its tile): __syncthreads_or over the tile's valid
//    samples keeps the threads in step.  nf_tpu stops per batch tile and its
//    chain on the whole batch; all stop only where max|x - prev| < ftol.
//  * Weights: one block of the stack is one contiguous weight block (9 KB at
//    F = 32, D = 2; 75 KB at F = 128, D = 8), staged into shared memory with
//    cp.async, double-buffered one block ahead;
//    fused_resflow.py::kernel_weights lays it out.
//  * Widths: FP in {8, 16, 32, 64, 128} and DP in {2, 4, 8}, zero-padded on
//    the host: padded features and dimensions stay exactly 0.  Wider stacks
//    do not fit a block's shared memory; the wrapper refuses them.  At
//    FP = 128 the loops over features that index no register array stay
//    rolled (Layout::kUnrollF): unrolled, they only lengthen the build.
//  * Numerics: accurate expf / exp2f and IEEE division, no fast math.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kProbes = 4;             // S: one warp per probe
constexpr int kT = 32 * kProbes;       // threads per block
constexpr int kNExact = 8;             // the serving estimator's n_exact
constexpr int kMaxTerms = kNExact + 32;

struct Params {
  const float* x;      // (B, D) input
  float* y;            // (B, D) output
  float* ld;           // (B,) log-det (LOGDET)
  const float* w;      // (n, Layout::kSize) per-block weight blocks
  const float* v;      // (S, B, D) probes (LOGDET)
  int n_terms[kProbes];
  int B, n, D, n_iters;
  float ftol, ld_sign, ld_const;
};

// One residual block's weight block, floats from its start;
// fused_resflow.py's Layout mirrors this.
template <int FP, int DP>
struct Layout {
  static constexpr bool kHasW2 = FP <= 64;        // double-buffered, fits twice
  static constexpr int kW2t = 0;                  // [FP][FP]  a2 = W2t h1
  static constexpr int kW2 = FP * FP;             // [FP][FP]  W2t^T (J^T rows), kHasW2
  static constexpr int kW1t = (kHasW2 ? 2 : 1) * FP * FP;  // [FP][DP]
  static constexpr int kB1 = kW1t + FP * DP;      // [FP]
  static constexpr int kB2 = kB1 + FP;            // [FP]
  static constexpr int kW3t = kB2 + FP;           // [DP][FP]
  static constexpr int kB3 = kW3t + DP * FP;      // [DP]
  static constexpr int kAnS = kB3 + DP;           // [DP]
  static constexpr int kAnB = kAnS + DP;          // [DP]
  static constexpr int kBeta = kAnB + DP;         // [2]
  static constexpr int kSize = (kBeta + 2 + 3) & ~3;
  // unroll factor of the loops over features that index no register array
  static constexpr int kUnrollF = FP <= 64 ? FP : 1;
};

// Samples per thread (of its warp's probe): two where the series runs and
// the two columns' t fit in registers, else one.  fused_resflow.py::columns
// mirrors this.
template <int FP, bool LOGDET>
constexpr int columns() {
  return (LOGDET && FP <= 32) ? 2 : 1;
}

// shared floats of one block of C columns (a tile of 32 C samples);
// fused_resflow.py::smem_bytes mirrors this
template <int FP, int DP, int C>
constexpr int smem_floats() {
  return 2 * Layout<FP, DP>::kSize + 4 * FP * 32 * C + kProbes * 32 * C;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float sigmoid(float a) { return 1.f / (1.f + expf(-a)); }

// LipSwish and its derivative at the pre-activation a
__device__ __forceinline__ void lipswish(float a, float beta, float& h, float& d) {
  const float s = sigmoid(beta * a);
  h = a * s / 1.1f;
  d = (s + beta * a * s * (1.f - s)) / 1.1f;
}

// Shared scratch of the tile: [FP][32 C] each, lane-consecutive.
struct Scratch {
  float* h1;
  float* d1;
  float* h2;
  float* d2;
  float* red;  // [kProbes][32 C]
};

// g's hidden layers at this lane's sample x, the 4 warps splitting the F
// features: h2 (and, with MASKS, d1 / d2) land in shared memory.  Ends on a
// barrier, so every thread may read them.
template <int FP, int DP, int C, bool MASKS>
__device__ __forceinline__ void hidden(const float* wc, const float (&x)[C][DP], const Scratch& s,
                                       int lane, int warp) {
  using L = Layout<FP, DP>;
  constexpr int kTile = 32 * C;
  constexpr int kQ = FP / kProbes;
  const float beta_a = wc[L::kBeta], beta_b = wc[L::kBeta + 1];
#pragma unroll (L::kUnrollF)
  for (int i = 0; i < kQ; ++i) {
    const int f = warp * kQ + i;
    float a[C];
#pragma unroll
    for (int c = 0; c < C; ++c) a[c] = 0.f;
#pragma unroll
    for (int d = 0; d < DP; ++d) {
      const float w = wc[L::kW1t + f * DP + d];
#pragma unroll
      for (int c = 0; c < C; ++c) a[c] = fmaf(w, x[c][d], a[c]);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float h, dd;
      lipswish(a[c] + wc[L::kB1 + f], beta_a, h, dd);
      s.h1[f * kTile + 32 * c + lane] = h;
      if (MASKS) s.d1[f * kTile + 32 * c + lane] = dd;
    }
  }
  __syncthreads();
  float hin[C][FP];
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int k = 0; k < FP; ++k) hin[c][k] = s.h1[k * kTile + 32 * c + lane];
#pragma unroll (L::kUnrollF)
  for (int i = 0; i < kQ; ++i) {
    const int f = warp * kQ + i;
    const float* row = wc + L::kW2t + f * FP;
    float a[C];
#pragma unroll
    for (int c = 0; c < C; ++c) a[c] = 0.f;
#pragma unroll
    for (int k = 0; k < FP; k += 4) {
      const float4 q = ld4(row + k);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        a[c] = fmaf(q.x, hin[c][k], a[c]);
        a[c] = fmaf(q.y, hin[c][k + 1], a[c]);
        a[c] = fmaf(q.z, hin[c][k + 2], a[c]);
        a[c] = fmaf(q.w, hin[c][k + 3], a[c]);
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float h, dd;
      lipswish(a[c] + wc[L::kB2 + f], beta_b, h, dd);
      s.h2[f * kTile + 32 * c + lane] = h;
      if (MASKS) s.d2[f * kTile + 32 * c + lane] = dd;
    }
  }
  __syncthreads();
}

// g(x) for this lane's sample from the h2 that hidden() left
template <int FP, int DP, int C>
__device__ __forceinline__ void output(const float* wc, const Scratch& s, int lane,
                                       float (&g)[C][DP]) {
  using L = Layout<FP, DP>;
  constexpr int kTile = 32 * C;
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int d = 0; d < DP; ++d) g[c][d] = 0.f;
#pragma unroll (L::kUnrollF)
  for (int f = 0; f < FP; ++f) {
    float h[C];
#pragma unroll
    for (int c = 0; c < C; ++c) h[c] = s.h2[f * kTile + 32 * c + lane];
#pragma unroll
    for (int d = 0; d < DP; ++d) {
      const float w = wc[L::kW3t + d * FP + f];
#pragma unroll
      for (int c = 0; c < C; ++c) g[c][d] = fmaf(w, h[c], g[c][d]);
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c)
#pragma unroll
    for (int d = 0; d < DP; ++d) g[c][d] += wc[L::kB3 + d];
}

// One probe's roulette series at the point of the masks d1 / d2:
// sum_{k <= nt} coef_k v . (J^T)^k v for this thread's (sample, probe).
template <int FP, int DP, int C>
__device__ __forceinline__ void series(const float* wc, const Scratch& s, int lane,
                                       const float (&v)[C][DP], int nt, float (&ser)[C]) {
  using L = Layout<FP, DP>;
  constexpr int kTile = 32 * C;
  float w[C][DP];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    ser[c] = 0.f;
#pragma unroll
    for (int d = 0; d < DP; ++d) w[c][d] = v[c][d];
  }
  for (int k = 1; k <= nt; ++k) {
    float t[C][FP];  // D2 (W3 w)
#pragma unroll
    for (int f = 0; f < FP; ++f) {
      float a[C];
#pragma unroll
      for (int c = 0; c < C; ++c) a[c] = 0.f;
#pragma unroll
      for (int d = 0; d < DP; ++d) {
        const float wt = wc[L::kW3t + d * FP + f];
#pragma unroll
        for (int c = 0; c < C; ++c) a[c] = fmaf(wt, w[c][d], a[c]);
      }
#pragma unroll
      for (int c = 0; c < C; ++c) t[c][f] = a[c] * s.d2[f * kTile + 32 * c + lane];
    }
    float wn[C][DP];
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int d = 0; d < DP; ++d) wn[c][d] = 0.f;
#pragma unroll 1
    for (int o = 0; o < FP; o += 4) {  // four rows of W2 t at a time
      float acc[C][4];
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[c][j] = 0.f;
      if constexpr (L::kHasW2) {
#pragma unroll
        for (int kk = 0; kk < FP; kk += 4) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float4 q = ld4(wc + L::kW2 + (o + j) * FP + kk);
#pragma unroll
            for (int c = 0; c < C; ++c) {
              acc[c][j] = fmaf(q.x, t[c][kk], acc[c][j]);
              acc[c][j] = fmaf(q.y, t[c][kk + 1], acc[c][j]);
              acc[c][j] = fmaf(q.z, t[c][kk + 2], acc[c][j]);
              acc[c][j] = fmaf(q.w, t[c][kk + 3], acc[c][j]);
            }
          }
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < FP; ++kk) {
          const float4 q = ld4(wc + L::kW2t + kk * FP + o);  // W2[o..o+3][kk]
#pragma unroll
          for (int c = 0; c < C; ++c) {
            acc[c][0] = fmaf(q.x, t[c][kk], acc[c][0]);
            acc[c][1] = fmaf(q.y, t[c][kk], acc[c][1]);
            acc[c][2] = fmaf(q.z, t[c][kk], acc[c][2]);
            acc[c][3] = fmaf(q.w, t[c][kk], acc[c][3]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {  // W1 (D1 .), folded in row by row
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float u = acc[c][j] * s.d1[(o + j) * kTile + 32 * c + lane];
#pragma unroll
          for (int d = 0; d < DP; ++d)
            wn[c][d] = fmaf(wc[L::kW1t + (o + j) * DP + d], u, wn[c][d]);
        }
      }
    }
    const float coef = ((k & 1) ? 1.f : -1.f) * exp2f((float)max(0, k - kNExact - 1)) / (float)k;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < DP; ++d) {
        dot = fmaf(wn[c][d], v[c][d], dot);
        w[c][d] = wn[c][d];
      }
      ser[c] = fmaf(coef, dot, ser[c]);
    }
  }
}

template <int FP, int DP, int C, bool SOLVE, bool LOGDET>
__global__ void __launch_bounds__(kT) fused_resflow_kernel(const Params prm) {
  using L = Layout<FP, DP>;
  constexpr int kTile = 32 * C;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float* buf = smem;  // 2 x kSize
  const Scratch s{smem + 2 * L::kSize, smem + 2 * L::kSize + FP * kTile,
                  smem + 2 * L::kSize + 2 * FP * kTile, smem + 2 * L::kSize + 3 * FP * kTile,
                  smem + 2 * L::kSize + 4 * FP * kTile};
  int sample[C];
  bool valid[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    sample[c] = blockIdx.x * kTile + 32 * c + lane;
    valid[c] = sample[c] < prm.B;
  }
  const int D = prm.D;

  auto block_of = [&](int step) { return SOLVE ? prm.n - 1 - step : step; };
  auto stage = [&](int step) {
    const float* src = prm.w + (size_t)block_of(step) * L::kSize;
    float* dst = buf + (step & 1) * L::kSize;
    for (int i = tid; i < L::kSize / 4; i += kT)
      __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
  };
  stage(0);
  __pipeline_commit();

  float x[C][DP], v[C][DP], acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    acc[c] = 0.f;
#pragma unroll
    for (int d = 0; d < DP; ++d) {
      x[c][d] = (valid[c] && d < D) ? prm.x[(size_t)sample[c] * D + d] : 0.f;
      v[c][d] = (LOGDET && valid[c] && d < D)
                    ? prm.v[((size_t)warp * prm.B + sample[c]) * D + d] : 0.f;
    }
  }

  for (int step = 0; step < prm.n; ++step) {
    // block `step` has landed and everyone is done with step - 1, whose
    // slot the next block now fills
    __pipeline_wait_prior(0);
    __syncthreads();
    if (step + 1 < prm.n) stage(step + 1);
    __pipeline_commit();
    const float* wc = buf + (step & 1) * L::kSize;
    float g[C][DP];

    if (SOLVE) {
      float z[C][DP], prev[C][DP];
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int d = 0; d < DP; ++d) z[c][d] = prev[c][d] = x[c][d];
      hidden<FP, DP, C, false>(wc, z, s, lane, warp);
      output<FP, DP, C>(wc, s, lane, g);
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int d = 0; d < DP; ++d) x[c][d] = z[c][d] - g[c][d];
      int it = 1;
      while (true) {
        bool moving = false;
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int d = 0; d < DP; ++d)
            moving |= valid[c] && fabsf(x[c][d] - prev[c][d]) >= prm.ftol;
        if (!(it < prm.n_iters && __syncthreads_or(moving))) break;
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int d = 0; d < DP; ++d) prev[c][d] = x[c][d];
        hidden<FP, DP, C, false>(wc, x, s, lane, warp);
        output<FP, DP, C>(wc, s, lane, g);
#pragma unroll
        for (int c = 0; c < C; ++c)
#pragma unroll
          for (int d = 0; d < DP; ++d) x[c][d] = z[c][d] - g[c][d];
        ++it;
      }
      if (LOGDET) hidden<FP, DP, C, true>(wc, x, s, lane, warp);  // the masks at the solved x
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c)
#pragma unroll
        for (int d = 0; d < DP; ++d)
          x[c][d] = (x[c][d] - wc[L::kAnB + d]) * expf(-wc[L::kAnS + d]);
      hidden<FP, DP, C, true>(wc, x, s, lane, warp);
      output<FP, DP, C>(wc, s, lane, g);
    }

    if (LOGDET) {
      float ser[C];
      series<FP, DP, C>(wc, s, lane, v, prm.n_terms[warp], ser);
#pragma unroll
      for (int c = 0; c < C; ++c) s.red[warp * kTile + 32 * c + lane] = ser[c];
      __syncthreads();
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int i = 32 * c + lane;
        acc[c] += (s.red[i] + s.red[kTile + i] + s.red[2 * kTile + i] + s.red[3 * kTile + i]) *
                  0.25f;
      }
    }
#pragma unroll
    for (int c = 0; c < C; ++c)
#pragma unroll
      for (int d = 0; d < DP; ++d)
        x[c][d] = SOLVE ? x[c][d] * expf(wc[L::kAnS + d]) + wc[L::kAnB + d] : x[c][d] + g[c][d];
  }

  if (warp == 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      if (!valid[c]) continue;
#pragma unroll
      for (int d = 0; d < DP; ++d)
        if (d < D) prm.y[(size_t)sample[c] * D + d] = x[c][d];
      if (LOGDET) prm.ld[sample[c]] = prm.ld_sign * acc[c] + prm.ld_const;
    }
  }
}

template <int FP, int DP, bool SOLVE, bool LOGDET>
cudaError_t launch(const Params& prm, cudaStream_t stream) {
  constexpr int C = columns<FP, LOGDET>();
  constexpr int kTile = 32 * C;
  const size_t smem = sizeof(float) * smem_floats<FP, DP, C>();
  auto kernel = fused_resflow_kernel<FP, DP, C, SOLVE, LOGDET>;
  static size_t opted_in = 48 * 1024;  // above 48 KB a block needs the opt-in
  if (smem > opted_in) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  kernel<<<(prm.B + kTile - 1) / kTile, kT, smem, stream>>>(prm);
  return cudaGetLastError();
}

template <int FP, int DP>
cudaError_t launch_variant(const Params& prm, int variant, cudaStream_t stream) {
  switch (variant) {
    case 0: return launch<FP, DP, true, false>(prm, stream);
    case 1: return launch<FP, DP, true, true>(prm, stream);
    case 2: return launch<FP, DP, false, true>(prm, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Plain C entry point: launches one variant (0 solve, 1 solve_ld, 2 fwd_ld)
// on `stream` and returns the cudaError_t of the launch (0 on success).
// (fp, dp) must be one of the tilings below, as fused_resflow.py's
// padded_width / padded_dim choose them; n_terms is a host array of the
// 4 probes' series lengths (read for the LOGDET variants).
extern "C" int nf_fused_resflow(const void* x, void* y, void* ld, const void* w, const void* v,
                                const int* n_terms, int B, int n, int D, int F,
                                int fp, int dp, int n_iters, float ftol, int variant,
                                float ld_sign, float ld_const, void* stream) {
  if (D < 1 || D > dp || F < 1 || F > fp || n < 1 || n_iters < 1 || variant < 0 || variant > 2)
    return (int)cudaErrorInvalidValue;
  const bool logdet = variant != 0;
  if (logdet && (v == nullptr || ld == nullptr || n_terms == nullptr))
    return (int)cudaErrorInvalidValue;
  Params prm{static_cast<const float*>(x), static_cast<float*>(y), static_cast<float*>(ld),
             static_cast<const float*>(w), static_cast<const float*>(v),
             {0, 0, 0, 0}, B, n, D, n_iters, ftol, ld_sign, ld_const};
  for (int s = 0; s < kProbes; ++s) {
    prm.n_terms[s] = logdet ? n_terms[s] : 0;
    if (logdet && (n_terms[s] < 1 || n_terms[s] > kMaxTerms)) return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define NF_TILING(FP_, DP_) \
  if (fp == FP_ && dp == DP_) return (int)launch_variant<FP_, DP_>(prm, variant, st);
  NF_TILING(8, 2)
  NF_TILING(8, 4)
  NF_TILING(8, 8)
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
#undef NF_TILING
  return (int)cudaErrorInvalidValue;
}
