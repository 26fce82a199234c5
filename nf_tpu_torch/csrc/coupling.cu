// Fused affine-coupling transform, its inverse and its analytic backward,
// Hopper (sm_90a).
//
// Replaces nf_tpu/ops/pallas/coupling.py: _fwd_kernel / _inv_kernel (via
// coupling_fwd_pallas / coupling_inv_pallas, launched by _call) and the
// analytic VJP _cf_bwd, which nf_tpu leaves to XLA.  Over (B, N) halves,
// with the scalars gain and bias read from device memory:
//   s  = tanh(raw_s) * gain + bias
//   forward:  y = z0 * exp(s) + t,     ld = sum_row(s)
//   inverse:  x = (y0 - t) * exp(-s),  ld = -sum_row(s)
//   backward, from gy (B, N) and gld (B,):
//     ds = gy * z0 * exp(s) + gld,  gz0 = gy * exp(s),
//     graw = ds * gain * (1 - tanh^2),  (gt = gy, no kernel work)
//     dgain = sum(ds * tanh),  dbias = sum(ds)
//
// Bound (H100 SXM): 16 bytes per element move for the forward and the
// inverse (three reads, one write), 20 for the backward (three reads, two
// writes), against about 5 f32 operations and 2 transcendentals (tanh,
// exp) per element.  At 3.35 TB/s that is 2.5 us per (1024, 512) call,
// so memory bounds it; at that size a launch costs as much as the work.
//
// Design.
//  * One warp per row, four rows per block of 128 threads: B = 1024 is 256
//    blocks over the 132 SMs, about 8 warps per SM.  A row is walked in
//    chunks of kUnroll float4 steps per lane, lane-strided, so a warp
//    reads 512 contiguous bytes per step of each operand (N % 128 == 0,
//    nf_tpu's gate, keeps every row float4-aligned).  Each lane issues all
//    of a chunk's loads (kUnroll steps x 3 operands, 48 floats in
//    registers) before its first transcendental, so it waits on DRAM once
//    per chunk: at N = 512 a chunk is the whole row, and an SM has about
//    48 KB of loads in flight.
//  * The row sums are a lane-local sum in a fixed order followed by an
//    xor-butterfly shuffle: no atomics, the same bits on every run.
//  * dgain and dbias in the same launch: each row writes its two partial
//    sums; the last block to finish (an atomic ticket in scratch that the
//    wrapper keeps per device and stream, after a __threadfence) folds all
//    B partials in one fixed order (thread k sums rows k, k + 128, ...,
//    then a butterfly per warp, then the four warps in order) and resets
//    the ticket for the next call.  So a backward is one launch, and two
//    runs give the same gradient bit for bit.
//  * tanh and exp are recomputed in the backward from the residuals
//    (z0, raw_s, gain, bias), as nf_tpu's _cf_bwd does; nothing else is
//    stored between the passes.
//  * No fast math: tanhf / expf are the accurate library functions.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kRowsPerBlock = 4;
constexpr int kThreads = 32 * kRowsPerBlock;
constexpr int kUnroll = 4;              // float4 steps per lane and chunk
constexpr int kChunk = 32 * kUnroll;    // float4 of a row per chunk
constexpr int kFold = 8;                // partials a folding thread loads at once

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

struct Elem {
  float out, s;
};

template <bool kInverse>
__device__ __forceinline__ Elem transform(float a, float t, float raw, float gain, float bias) {
  const float s = tanhf(raw) * gain + bias;
  return kInverse ? Elem{(a - t) * expf(-s), s} : Elem{a * expf(s) + t, s};
}

template <bool kInverse>
__global__ void __launch_bounds__(kThreads)
    coupling_kernel(const float4* __restrict__ a, const float4* __restrict__ t,
                    const float4* __restrict__ raw, const float* __restrict__ gain,
                    const float* __restrict__ bias, float4* __restrict__ out,
                    float* __restrict__ ld, int B, int n4) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= B) return;  // warp-uniform
  const float g = __ldg(gain), b = __ldg(bias);
  const size_t base = static_cast<size_t>(row) * n4;
  float acc = 0.f;
  for (int c0 = lane; c0 < n4; c0 += kChunk) {
    float4 av[kUnroll], tv[kUnroll], rv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = c0 + 32 * u;
      if (i < n4) {
        av[u] = a[base + i];
        tv[u] = t[base + i];
        rv[u] = raw[base + i];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int i = c0 + 32 * u;
      if (i < n4) {
        const Elem ex = transform<kInverse>(av[u].x, tv[u].x, rv[u].x, g, b);
        const Elem ey = transform<kInverse>(av[u].y, tv[u].y, rv[u].y, g, b);
        const Elem ez = transform<kInverse>(av[u].z, tv[u].z, rv[u].z, g, b);
        const Elem ew = transform<kInverse>(av[u].w, tv[u].w, rv[u].w, g, b);
        out[base + i] = make_float4(ex.out, ey.out, ez.out, ew.out);
        acc += (ex.s + ey.s) + (ez.s + ew.s);
      }
    }
  }
  acc = warp_sum(acc);
  if (lane == 0) ld[row] = kInverse ? -acc : acc;
}

struct Grad {
  float gz0, graw, ds_th, ds;
};

__device__ __forceinline__ Grad grad(float gy, float z0, float raw, float gld, float gain,
                                     float bias) {
  const float th = tanhf(raw);
  const float es = expf(th * gain + bias);
  const float ds = gy * z0 * es + gld;
  return Grad{gy * es, ds * gain * (1.f - th * th), ds * th, ds};
}

// The rows' gradients and, in the block that finishes last, dgain = sum of
// partial[:].x and dbias = sum of partial[:].y in a fixed order.
__global__ void __launch_bounds__(kThreads)
    coupling_bwd_kernel(const float4* __restrict__ gy, const float* __restrict__ gld,
                        const float4* __restrict__ z0, const float4* __restrict__ raw,
                        const float* __restrict__ gain, const float* __restrict__ bias,
                        float4* __restrict__ gz0, float4* __restrict__ graw,
                        float2* __restrict__ partial, unsigned int* __restrict__ ticket,
                        float* __restrict__ dgain, float* __restrict__ dbias, int B, int n4) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = blockIdx.x * kRowsPerBlock + warp;
  if (row < B) {  // warp-uniform; every block goes on to the ticket
    const float g = __ldg(gain), b = __ldg(bias), gl = gld[row];
    const size_t base = static_cast<size_t>(row) * n4;
    float acc_th = 0.f, acc = 0.f;
    for (int c0 = lane; c0 < n4; c0 += kChunk) {
      float4 gv[kUnroll], zv[kUnroll], rv[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = c0 + 32 * u;
        if (i < n4) {
          gv[u] = gy[base + i];
          zv[u] = z0[base + i];
          rv[u] = raw[base + i];
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int i = c0 + 32 * u;
        if (i < n4) {
          const Grad x = grad(gv[u].x, zv[u].x, rv[u].x, gl, g, b);
          const Grad y = grad(gv[u].y, zv[u].y, rv[u].y, gl, g, b);
          const Grad z = grad(gv[u].z, zv[u].z, rv[u].z, gl, g, b);
          const Grad w = grad(gv[u].w, zv[u].w, rv[u].w, gl, g, b);
          gz0[base + i] = make_float4(x.gz0, y.gz0, z.gz0, w.gz0);
          graw[base + i] = make_float4(x.graw, y.graw, z.graw, w.graw);
          acc_th += (x.ds_th + y.ds_th) + (z.ds_th + w.ds_th);
          acc += (x.ds + y.ds) + (z.ds + w.ds);
        }
      }
    }
    acc_th = warp_sum(acc_th);
    acc = warp_sum(acc);
    if (lane == 0) partial[row] = make_float2(acc_th, acc);
  }

  // the last block to take a ticket sees every row's partials
  __shared__ bool last;
  __shared__ float sg[kRowsPerBlock], sb[kRowsPerBlock];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // thread k adds rows k, k + kThreads, ... in order, kFold loads in flight
  float ag = 0.f, ab = 0.f;
  for (int r0 = threadIdx.x; r0 < B; r0 += kFold * kThreads) {
    float2 p[kFold];
#pragma unroll
    for (int k = 0; k < kFold; ++k) {
      const int r = r0 + k * kThreads;
      p[k] = r < B ? __ldcg(partial + r) : make_float2(0.f, 0.f);
    }
#pragma unroll
    for (int k = 0; k < kFold; ++k) {
      ag += p[k].x;
      ab += p[k].y;
    }
  }
  ag = warp_sum(ag);
  ab = warp_sum(ab);
  if (lane == 0) {
    sg[warp] = ag;
    sb[warp] = ab;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float tg = 0.f, tb = 0.f;
#pragma unroll
    for (int w = 0; w < kRowsPerBlock; ++w) {
      tg += sg[w];
      tb += sb[w];
    }
    *dgain = tg;
    *dbias = tb;
    *ticket = 0u;  // ready for the next call on this stream
  }
}

int blocks_for(int B) { return (B + kRowsPerBlock - 1) / kRowsPerBlock; }

}  // namespace

// Forward (inverse = 0) or inverse (inverse = 1) over contiguous float32
// (B, n) tensors, n % 4 == 0 and every pointer 16-byte aligned (the
// wrapper checks).  Returns cudaGetLastError() after the launch.
extern "C" int nf_coupling(const void* a, const void* t, const void* raw, const void* gain,
                           const void* bias, void* out, void* ld, int B, int n, int inverse,
                           void* stream) {
  if (B <= 0) return 0;
  if (n <= 0 || n % 4 != 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* a4 = static_cast<const float4*>(a);
  const auto* t4 = static_cast<const float4*>(t);
  const auto* r4 = static_cast<const float4*>(raw);
  const auto* g = static_cast<const float*>(gain);
  const auto* b = static_cast<const float*>(bias);
  auto* o4 = static_cast<float4*>(out);
  auto* l = static_cast<float*>(ld);
  if (inverse)
    coupling_kernel<true><<<blocks_for(B), kThreads, 0, st>>>(a4, t4, r4, g, b, o4, l, B, n / 4);
  else
    coupling_kernel<false><<<blocks_for(B), kThreads, 0, st>>>(a4, t4, r4, g, b, o4, l, B, n / 4);
  return (int)cudaGetLastError();
}

// Backward of the forward, ONE launch: gz0, graw (B, n), the per-row
// partials (B, 2) (scratch), dgain, dbias (1,) each; `ticket` is one
// unsigned int in device memory that is 0 on entry (the wrapper zeroes it
// once per device and stream; every call leaves it 0).  B = 0 launches one
// block that writes dgain = dbias = 0.
extern "C" int nf_coupling_bwd(const void* gy, const void* gld, const void* z0, const void* raw,
                               const void* gain, const void* bias, void* gz0, void* graw,
                               void* partial, void* ticket, void* dgain, void* dbias, int B,
                               int n, void* stream) {
  if (n <= 0 || n % 4 != 0 || B < 0) return (int)cudaErrorInvalidValue;
  const int blocks = B > 0 ? blocks_for(B) : 1;
  coupling_bwd_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(gy), static_cast<const float*>(gld),
      static_cast<const float4*>(z0), static_cast<const float4*>(raw),
      static_cast<const float*>(gain), static_cast<const float*>(bias),
      static_cast<float4*>(gz0), static_cast<float4*>(graw), static_cast<float2*>(partial),
      static_cast<unsigned int*>(ticket), static_cast<float*>(dgain), static_cast<float*>(dbias),
      B, n / 4);
  return (int)cudaGetLastError();
}
