// Whole-stack eval kernel for RealNVP / Glow density flows, Hopper (sm_90a).
//
// Replaces nf_tpu/ops/pallas/fused_stack.py::_make_kernels (fwd_kernel /
// inv_kernel) in both variants: RealNVP (flow-BatchNorm norms, no mix) and
// Glow (ActNorm norms, PLU 1x1 mix, template MIX).  The eval-mode forward
// or inverse of
//
//     n x [ channel affine -> (D x D mix)? -> affine coupling with the 6-layer MLP ]
//
// in ONE launch.  Per coupling c (parity p = c & 1):
//   forward:  x = (x - shift) * scale;  MIX: x = W x per sample
//   z1 = rows 2k+1-p, z0 = rows 2i+p of x
//   h  = W0 z1 + b0
//   2 x [ u = relu(h*A1+B1); u = W u + b1; u = relu(u*A2+B2);
//         u = W u + b2; h += u ]
//   raw = Wh relu(h*Ah+Bh) + bh;  t = raw[:out], s = tanh(raw[out:])*g + b
//   forward:  z0 = z0 * exp(s) + t,   ld += sum(s)
//   inverse:  z0 = (z0 - t) * exp(-s), ld -= sum(s), MIX: x = W^-1 x,
//             then x = x/scale + shift
// The inverse walks c = n-1 .. 0.  All constants (weight norm, BN eval
// affines, ActNorm, the PLU product W = P L U and its inverse, every
// constant log-det) are folded on the host by pack_stack / kernel_weights
// in nf_tpu_torch/ops/cuda/fused_stack.py; ld starts at 0 and the folded
// constant ld_const is added at the end.  ActNorm needs nothing of its
// own here: it is the same channel affine as the flow-BatchNorm.
//
// Bound (H100 SXM, 67 TFLOP/s f32 on CUDA cores): per sample and coupling
// in*F + 4*F*F + 2*out*F multiply-adds (4,192 at D = 2, F = 32) and about
// 22*F elementwise operations, ~2.4 GFLOP per direction at B = 8192,
// n = 32; HBM traffic is under 1 MB.  So f32 arithmetic bounds it.  The
// Glow mix adds 2*D*D flop per sample and coupling.
//
// Design.
//  * One block owns S samples for the whole walk over the n couplings; the
//    sequential layer loop is the loop inside the block, there is no
//    cross-block state.  Activations live in shared memory feature-major,
//    act[k][s], so the conditioner's four F x F layers are small GEMMs
//    act(S x F) x W^T.
//  * Register tiling for the CUDA cores: each thread owns a TS x 4
//    (samples x features) tile of every layer's output, the same tile in
//    every layer, so the residual stream h stays in its registers and each
//    layer's bias / BN-affine / ReLU epilogue is applied exactly once, by
//    the owner, before the next layer's input is written.  Per k step a
//    thread does 4*TS FMAs for one float4 weight load and one TS-wide
//    activation load, both from shared memory.
//  * Occupancy: at F = 32 a block is 64 samples x 32 features with TS = 2,
//    256 threads, so B = 8192 is 128 blocks, one per SM of the 132, 8 warps
//    each.  Among the tilings timed on an H100 (32 or 64 samples, TS 2 or
//    4) this was the fastest in both directions: TS = 4 halves the warps
//    per SM, 32 samples per block fetches every weight twice as often.
//  * Weights do not fit in shared memory (4 F x F per coupling, 512 KB
//    for n = 32, F = 32), and a block that waits on L2 at every layer is
//    latency-bound at this occupancy.  So the weights stream through a
//    two-slot ring of TK x FP chunks (the whole layer for FP <= 64): while
//    one chunk is multiplied, cp.async brings the next one, across layer
//    and coupling boundaries, and a coupling's small tensors (BN affines,
//    biases, in-projection, head, norm) arrive the same way into a
//    two-slot header one coupling ahead.  One barrier per chunk both
//    publishes the chunk and the previous layer's activations.
//  * K = 1: the in-projection is a runtime loop over the n_in conditioning
//    rows, an outer product when D = 2.
//  * The Glow mix is D x D per sample: one thread per sample applies it,
//    with the D normalized (forward) or coupled (inverse) values parked in
//    the head's scratch rows, and W / W^-1 travel in the coupling's header.
//    MIX is a template parameter, so the RealNVP instantiation is the
//    kernel without it.
//  * Widths: FP is F rounded up to 8, 16, ..., 256 on the host with zero
//    weights, which keeps the padded features exactly 0.  The x tile and
//    the head's rows are D x S in shared memory and the header holds the
//    D-wide rows, so a wide D takes the 16-sample tiling, or the cluster
//    kernel of csrc/fused_stack_wide.cu at the widths where that ran
//    faster and past the 16-sample tiling (fused_stack.py::ffma_plan).
//  * Sources: this header holds the kernel, csrc/fused_stack.cu
//    instantiates it at TILES and NARROW_TILE.  A ragged batch tail loads
//    zeros and stores nothing.
//  * Accurate expf / tanhf (no fast math): the results are held against
//    the plain PyTorch version.

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTO = 4;     // features per thread tile (one float4)
constexpr int kNVec = 15;  // per-coupling vectors, order as pack_stack's VEC

struct Params {
  const float* x;     // (B, D)
  float* y;           // (B, D)
  float* ld;          // (B,)
  const float* pre;   // (n, D, 2)  forward (shift, scale) / inverse (shift, 1/scale)
  const float* mix;   // (n, D, D)  W forward / W^-1 inverse (MIX only), row-major (out, in)
  const float* w0t;   // (n, half, FP)     in-projection, k-major
  const float* vec;   // (n, 15, FP)
  const float* wrt;   // (n, 4, FP, FP)    resblock layers, k-major
  const float* wh;    // (n, 2*half, FP)   head: t rows, then s rows from half
  const float* bh;    // (n, 2*half)
  const float* gb;    // (n, 2)            coupling (gain, bias)
  int B, D, n;
  float ld_const;
};

__host__ __device__ constexpr int chunk_rows(int fp) {
  return fp * fp <= 4096 ? fp : 4096 / fp;
}

__host__ __device__ constexpr int align4(int v) { return (v + 3) & ~3; }

// One coupling's header in shared memory, floats from its start:
//   vec [15][FP] | w0t [half][FP] | wh [2*half][FP] | bh [2*half] gb [2] pre [D][2]
//   | mix [D][D] (MIX only)
struct Header {
  int w0t, wh, bh, gb, pre, mix, size;
  __host__ __device__ constexpr Header(int fp, int d, bool has_mix)
      : w0t(kNVec * fp), wh(w0t + ((d + 1) / 2) * fp), bh(wh + 2 * ((d + 1) / 2) * fp),
        gb(bh + 2 * ((d + 1) / 2)), pre(gb + 2), mix(pre + 2 * d),
        size(align4(mix + (has_mix ? d * d : 0))) {}
};

// shared floats of one block; fused_stack.py::smem_bytes mirrors this
__host__ __device__ constexpr int smem_floats(int fp, int s, int d, bool has_mix) {
  return 2 * fp * (s + 4) + 2 * chunk_rows(fp) * fp + 2 * Header(fp, d, has_mix).size +
         d * (s + 4) + 2 * ((d + 1) / 2) * (s + 4) + s;
}

template <int TS>
__device__ __forceinline__ void load_ts(float (&v)[TS], const float* p);

template <>
__device__ __forceinline__ void load_ts<4>(float (&v)[4], const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

template <>
__device__ __forceinline__ void load_ts<2>(float (&v)[2], const float* p) {
  const float2 q = *reinterpret_cast<const float2*>(p);
  v[0] = q.x; v[1] = q.y;
}

template <int TS>
__device__ __forceinline__ void store_ts(float* p, const float (&v)[TS]);

template <>
__device__ __forceinline__ void store_ts<4>(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

template <>
__device__ __forceinline__ void store_ts<2>(float* p, const float (&v)[2]) {
  *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

__device__ __forceinline__ void lds4(float (&v)[kTO], const float* p) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

// asynchronous copy of n floats, global -> shared, by all T threads
template <int T>
__device__ __forceinline__ void copy16(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n / 4; i += T)
    __pipeline_memcpy_async(dst + 4 * i, src + 4 * i, 16);
}

template <int T>
__device__ __forceinline__ void copy4(float* dst, const float* src, int n) {
  for (int i = threadIdx.x; i < n; i += T) __pipeline_memcpy_async(dst + i, src + i, 4);
}

// The weight stream: chunk q is rows [k0, k0+TK) of layer l of the coupling
// at walk step s, q = (s * 4 + l) * NCH + k0 / TK.
template <int FP, int T, bool INV, bool MIX>
struct Stream {
  static constexpr int TK = chunk_rows(FP);
  static constexpr int NCH = FP / TK;
  const Params prm;
  float* w_s;    // 2 x TK x FP
  float* hdr;    // 2 x Header(FP, D).size
  Header h;

  __device__ int coupling(int step) const { return INV ? prm.n - 1 - step : step; }
  __device__ const float* header(int step) const { return hdr + (step & 1) * h.size; }
  __device__ const float* chunk(int q) const { return w_s + (q & 1) * TK * FP; }

  __device__ void issue_header(int step) const {
    const int c = coupling(step), half = (prm.D + 1) / 2;
    float* dst = hdr + (step & 1) * h.size;
    copy16<T>(dst, prm.vec + (size_t)c * kNVec * FP, kNVec * FP);
    copy16<T>(dst + h.w0t, prm.w0t + (size_t)c * half * FP, half * FP);
    copy16<T>(dst + h.wh, prm.wh + (size_t)c * 2 * half * FP, 2 * half * FP);
    copy4<T>(dst + h.bh, prm.bh + (size_t)c * 2 * half, 2 * half);
    copy4<T>(dst + h.gb, prm.gb + 2 * c, 2);
    copy4<T>(dst + h.pre, prm.pre + (size_t)c * 2 * prm.D, 2 * prm.D);
    if (MIX) copy4<T>(dst + h.mix, prm.mix + (size_t)c * prm.D * prm.D, prm.D * prm.D);
  }

  // start chunk q's copy; the header of step s+1 goes with the first chunk
  // of layer 1 of step s, so it lands a whole coupling before it is read
  __device__ void issue(int q) const {
    const int step = q / (4 * NCH), layer = (q / NCH) % 4, k0 = (q % NCH) * TK;
    if (step >= prm.n) return;
    const float* src = prm.wrt + ((size_t)(coupling(step) * 4 + layer) * FP + k0) * FP;
    copy16<T>(w_s + (q & 1) * TK * FP, src, TK * FP);
    if (layer == 1 && k0 == 0 && step + 1 < prm.n) issue_header(step + 1);
  }
};

// acc[j][i] = sum_k w[k][o0+j] * act[k][s0+i] over k < FP for layer `layer`
// of walk step `step`.  Per chunk: wait for it, one barrier (which also
// publishes the caller's writes to act and frees the other slot), start
// the next chunk's copy, multiply.
template <int FP, int S, int TS, bool INV, bool MIX>
__device__ __forceinline__ void layer_gemm(const Stream<FP, (S / TS) * (FP / kTO), INV, MIX>& st,
                                           const float* act, int step, int layer,
                                           int o0, int s0, float (&acc)[kTO][TS]) {
  constexpr int SP = S + 4;
  constexpr int TK = chunk_rows(FP);
  constexpr int NCH = FP / TK;
#pragma unroll
  for (int j = 0; j < kTO; ++j)
#pragma unroll
    for (int i = 0; i < TS; ++i) acc[j][i] = 0.f;
  for (int ch = 0; ch < NCH; ++ch) {
    const int q = (step * 4 + layer) * NCH + ch;
    __pipeline_wait_prior(0);
    __syncthreads();
    st.issue(q + 1);
    __pipeline_commit();
    const float* w = st.chunk(q);
    const float* a_k = act + ch * TK * SP + s0;
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float wv[kTO], a[TS];
      lds4(wv, w + kk * FP + o0);
      load_ts<TS>(a, a_k + kk * SP);
#pragma unroll
      for (int j = 0; j < kTO; ++j)
#pragma unroll
        for (int i = 0; i < TS; ++i) acc[j][i] = fmaf(wv[j], a[i], acc[j][i]);
    }
  }
}

// out[o0+j][s0+i] = relu(v[j][i] * A[j] + Bv[j]), A / Bv header vectors
template <int S, int TS>
__device__ __forceinline__ void store_bn_relu(float* out, const float (&v)[kTO][TS],
                                              const float* vec_a, const float* vec_b,
                                              int o0, int s0) {
  constexpr int SP = S + 4;
  float A[kTO], Bv[kTO];
  lds4(A, vec_a + o0);
  lds4(Bv, vec_b + o0);
#pragma unroll
  for (int j = 0; j < kTO; ++j) {
    float r[TS];
#pragma unroll
    for (int i = 0; i < TS; ++i) r[i] = fmaxf(v[j][i] * A[j] + Bv[j], 0.f);
    store_ts<TS>(out + (o0 + j) * SP + s0, r);
  }
}

template <int FP, int S, int TS, bool INV, bool MIX>
__global__ void __launch_bounds__((S / TS) * (FP / kTO))
fused_stack_kernel(const Params prm) {
  constexpr int T = (S / TS) * (FP / kTO);
  constexpr int SP = S + 4;
  constexpr int TK = chunk_rows(FP);
  extern __shared__ __align__(16) float smem[];
  const int D = prm.D;
  const int half = (D + 1) / 2;  // in_max == out_max
  const Header hd(FP, D, MIX);
  float* buf_a = smem;                    // FP x SP
  float* buf_b = buf_a + FP * SP;         // FP x SP
  float* w_s = buf_b + FP * SP;           // 2 x TK x FP
  float* hdr = w_s + 2 * TK * FP;         // 2 x hd.size
  float* x_s = hdr + 2 * hd.size;         // D x SP
  float* raw_s = x_s + D * SP;            // 2*half x SP
  float* ld_s = raw_s + 2 * half * SP;    // S
  const Stream<FP, T, INV, MIX> st{prm, w_s, hdr, hd};

  const int tid = threadIdx.x;
  const int o0 = (tid % (FP / kTO)) * kTO;
  const int s0 = (tid / (FP / kTO)) * TS;
  const int base = blockIdx.x * S;

  st.issue_header(0);
  st.issue(0);
  __pipeline_commit();
  for (int i = tid; i < S * D; i += T) {
    const int s = i / D, d = i % D;
    x_s[d * SP + s] = base + s < prm.B ? prm.x[(size_t)(base + s) * D + d] : 0.f;
  }
  for (int s = tid; s < S; s += T) ld_s[s] = 0.f;
  __pipeline_wait_prior(0);
  __syncthreads();

  float h[kTO][TS];    // residual stream of this thread's tile
  float acc[kTO][TS];
  for (int step = 0; step < prm.n; ++step) {
    const int p = st.coupling(step) & 1;
    const int n_out = (D + 1 - p) / 2, n_in = (D + p) / 2;
    const float* head = st.header(step);
    const float* vec = head;
    const float* pre = head + hd.pre;

    if (!INV) {
      if (MIX) {
        // one thread per sample: normalize into raw_s's rows, then x = W x
        const float* mx = head + hd.mix;
        for (int s = tid; s < S; s += T) {
          for (int d = 0; d < D; ++d)
            raw_s[d * SP + s] = (x_s[d * SP + s] - pre[2 * d]) * pre[2 * d + 1];
          for (int d = 0; d < D; ++d) {
            float a = 0.f;
            for (int k = 0; k < D; ++k) a = fmaf(mx[d * D + k], raw_s[k * SP + s], a);
            x_s[d * SP + s] = a;
          }
        }
      } else {
        for (int i = tid; i < D * S; i += T) {
          const int d = i / S, s = i % S;
          x_s[d * SP + s] = (x_s[d * SP + s] - pre[2 * d]) * pre[2 * d + 1];
        }
      }
      __syncthreads();
    }

    // in-projection h = W0 z1 + b0 (an outer product when n_in == 1)
    {
      const float* w0 = head + hd.w0t;
#pragma unroll
      for (int j = 0; j < kTO; ++j)
#pragma unroll
        for (int i = 0; i < TS; ++i) acc[j][i] = 0.f;
      for (int k = 0; k < n_in; ++k) {
        float wv[kTO], z[TS];
        lds4(wv, w0 + k * FP + o0);
        load_ts<TS>(z, x_s + (2 * k + 1 - p) * SP + s0);
#pragma unroll
        for (int j = 0; j < kTO; ++j)
#pragma unroll
          for (int i = 0; i < TS; ++i) acc[j][i] = fmaf(wv[j], z[i], acc[j][i]);
      }
      float b0[kTO];
      lds4(b0, vec + o0);
#pragma unroll
      for (int j = 0; j < kTO; ++j)
#pragma unroll
        for (int i = 0; i < TS; ++i) h[j][i] = acc[j][i] + b0[j];
      store_bn_relu<S, TS>(buf_a, h, vec + 1 * FP, vec + 2 * FP, o0, s0);
    }

    // two residual blocks: buf_a -> buf_b -> buf_a, twice
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int o = 1 + 6 * r;
      float bias[kTO];
      layer_gemm<FP, S, TS, INV, MIX>(st, buf_a, step, 2 * r, o0, s0, acc);
      lds4(bias, vec + (o + 2) * FP + o0);
#pragma unroll
      for (int j = 0; j < kTO; ++j)
#pragma unroll
        for (int i = 0; i < TS; ++i) acc[j][i] += bias[j];
      store_bn_relu<S, TS>(buf_b, acc, vec + (o + 3) * FP, vec + (o + 4) * FP, o0, s0);

      layer_gemm<FP, S, TS, INV, MIX>(st, buf_b, step, 2 * r + 1, o0, s0, acc);
      lds4(bias, vec + (o + 5) * FP + o0);
#pragma unroll
      for (int j = 0; j < kTO; ++j)
#pragma unroll
        for (int i = 0; i < TS; ++i) h[j][i] += acc[j][i] + bias[j];
      // next block's pre-activation, or the head's after the last block
      const int na = r == 0 ? 7 : 13;
      store_bn_relu<S, TS>(buf_a, h, vec + na * FP, vec + (na + 1) * FP, o0, s0);
    }
    __syncthreads();

    // head: raw[j][s] = sum_k wh[j][k] * buf_a[k][s] + bh[j]
    {
      const float* wh = head + hd.wh;
      for (int i = tid; i < 2 * half * S; i += T) {
        const int j = i / S, s = i % S;
        if ((j < half ? j : j - half) >= n_out) continue;
        float a = 0.f;
#pragma unroll 8
        for (int k = 0; k < FP; ++k) a = fmaf(wh[j * FP + k], buf_a[k * SP + s], a);
        raw_s[j * SP + s] = a + head[hd.bh + j];
      }
    }
    __syncthreads();

    // coupling: one thread per sample
    {
      const float gain = head[hd.gb], cbias = head[hd.gb + 1];
      for (int s = tid; s < S; s += T) {
        float lsum = 0.f;
        for (int i = 0; i < n_out; ++i) {
          const float t = raw_s[i * SP + s];
          const float sv = tanhf(raw_s[(half + i) * SP + s]) * gain + cbias;
          float* xr = x_s + (2 * i + p) * SP + s;
          *xr = INV ? (*xr - t) * expf(-sv) : *xr * expf(sv) + t;
          lsum += sv;
        }
        ld_s[s] += INV ? -lsum : lsum;
        if (INV && MIX) {
          // this sample's raw_s column is consumed: park x there, then
          // x = W^-1 x and the un-affine
          const float* mx = head + hd.mix;
          for (int d = 0; d < D; ++d) raw_s[d * SP + s] = x_s[d * SP + s];
          for (int d = 0; d < D; ++d) {
            float a = 0.f;
            for (int k = 0; k < D; ++k) a = fmaf(mx[d * D + k], raw_s[k * SP + s], a);
            x_s[d * SP + s] = a * pre[2 * d + 1] + pre[2 * d];
          }
        } else if (INV) {
          for (int d = 0; d < D; ++d)
            x_s[d * SP + s] = x_s[d * SP + s] * pre[2 * d + 1] + pre[2 * d];
        }
      }
    }
    __syncthreads();
  }

  for (int i = tid; i < S * D; i += T) {
    const int s = i / D, d = i % D;
    if (base + s < prm.B) prm.y[(size_t)(base + s) * D + d] = x_s[d * SP + s];
  }
  for (int s = tid; s < S; s += T)
    if (base + s < prm.B) prm.ld[base + s] = ld_s[s] + prm.ld_const;
}

template <int FP, int S, int TS, bool INV, bool MIX>
cudaError_t launch(const Params& prm, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(FP, S, prm.D, MIX);
  if (smem > 232448) return cudaErrorInvalidValue;
  auto kernel = fused_stack_kernel<FP, S, TS, INV, MIX>;
  // above 48 KB a block needs the opt-in; raise it once per size reached
  static size_t opted_in = 48 * 1024;
  if (smem > opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  const int grid = (prm.B + S - 1) / S;
  kernel<<<grid, (S / TS) * (FP / kTO), smem, stream>>>(prm);
  return cudaGetLastError();
}

template <int FP, int S, int TS>
cudaError_t launch_dir(const Params& prm, bool inverse, bool mix, cudaStream_t stream) {
  if (mix)
    return inverse ? launch<FP, S, TS, true, true>(prm, stream)
                   : launch<FP, S, TS, false, true>(prm, stream);
  return inverse ? launch<FP, S, TS, true, false>(prm, stream)
                 : launch<FP, S, TS, false, false>(prm, stream);
}

// the kernel's parameters from the entry points' plain C arguments
inline Params params_of(const void* x, void* y, void* ld, const void* pre, const void* mix,
                        const void* w0t, const void* vec, const void* wrt, const void* wh,
                        const void* bh, const void* gb, int B, int D, int n, float ld_const) {
  return Params{static_cast<const float*>(x), static_cast<float*>(y),
                static_cast<float*>(ld), static_cast<const float*>(pre),
                static_cast<const float*>(mix),
                static_cast<const float*>(w0t), static_cast<const float*>(vec),
                static_cast<const float*>(wrt), static_cast<const float*>(wh),
                static_cast<const float*>(bh), static_cast<const float*>(gb), B, D, n,
                ld_const};
}

}  // namespace
