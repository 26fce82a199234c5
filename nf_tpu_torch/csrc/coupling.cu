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
//    blocks over the 132 SMs.  Each lane walks its row in float4 steps,
//    lane-strided, so a warp reads 512 contiguous bytes per step of each
//    operand (N % 128 == 0, nf_tpu's gate, keeps every row float4-aligned).
//  * The row sums are a lane-local sum in a fixed order followed by an
//    xor-butterfly shuffle: no atomics, the same bits on every run.
//  * dgain and dbias: each row writes its two partial sums; a second,
//    one-block launch in the same call folds the B partials in a fixed
//    order (strided per thread, then a shared-memory tree), so two runs
//    give the same gradient.
//  * tanh and exp are recomputed in the backward from the residuals
//    (z0, raw_s, gain, bias), as nf_tpu's _cf_bwd does; nothing else is
//    stored between the passes.
//  * No fast math: tanhf / expf are the accurate library functions.
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kRowsPerBlock = 4;
constexpr int kThreads = 32 * kRowsPerBlock;
constexpr int kReduceThreads = 256;

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
  for (int i = lane; i < n4; i += 32) {
    const float4 av = a[base + i], tv = t[base + i], rv = raw[base + i];
    const Elem ex = transform<kInverse>(av.x, tv.x, rv.x, g, b);
    const Elem ey = transform<kInverse>(av.y, tv.y, rv.y, g, b);
    const Elem ez = transform<kInverse>(av.z, tv.z, rv.z, g, b);
    const Elem ew = transform<kInverse>(av.w, tv.w, rv.w, g, b);
    out[base + i] = make_float4(ex.out, ey.out, ez.out, ew.out);
    acc += (ex.s + ey.s) + (ez.s + ew.s);
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

__global__ void __launch_bounds__(kThreads)
    coupling_bwd_kernel(const float4* __restrict__ gy, const float* __restrict__ gld,
                        const float4* __restrict__ z0, const float4* __restrict__ raw,
                        const float* __restrict__ gain, const float* __restrict__ bias,
                        float4* __restrict__ gz0, float4* __restrict__ graw,
                        float2* __restrict__ partial, int B, int n4) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= B) return;  // warp-uniform
  const float g = __ldg(gain), b = __ldg(bias), gl = gld[row];
  const size_t base = static_cast<size_t>(row) * n4;
  float acc_th = 0.f, acc = 0.f;
  for (int i = lane; i < n4; i += 32) {
    const float4 gv = gy[base + i], zv = z0[base + i], rv = raw[base + i];
    const Grad x = grad(gv.x, zv.x, rv.x, gl, g, b);
    const Grad y = grad(gv.y, zv.y, rv.y, gl, g, b);
    const Grad z = grad(gv.z, zv.z, rv.z, gl, g, b);
    const Grad w = grad(gv.w, zv.w, rv.w, gl, g, b);
    gz0[base + i] = make_float4(x.gz0, y.gz0, z.gz0, w.gz0);
    graw[base + i] = make_float4(x.graw, y.graw, z.graw, w.graw);
    acc_th += (x.ds_th + y.ds_th) + (z.ds_th + w.ds_th);
    acc += (x.ds + y.ds) + (z.ds + w.ds);
  }
  acc_th = warp_sum(acc_th);
  acc = warp_sum(acc);
  if (lane == 0) partial[row] = make_float2(acc_th, acc);
}

// One block: dgain = sum of partial[:].x, dbias = sum of partial[:].y, in a
// fixed order (thread k sums rows k, k + 256, ...; then a tree).
__global__ void __launch_bounds__(kReduceThreads)
    reduce_partials_kernel(const float2* __restrict__ partial, int B,
                           float* __restrict__ dgain, float* __restrict__ dbias) {
  __shared__ float sg[kReduceThreads], sb[kReduceThreads];
  float ag = 0.f, ab = 0.f;
  for (int r = threadIdx.x; r < B; r += kReduceThreads) {
    const float2 p = partial[r];
    ag += p.x;
    ab += p.y;
  }
  sg[threadIdx.x] = ag;
  sb[threadIdx.x] = ab;
  __syncthreads();
  for (int s = kReduceThreads / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) {
      sg[threadIdx.x] += sg[threadIdx.x + s];
      sb[threadIdx.x] += sb[threadIdx.x + s];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    *dgain = sg[0];
    *dbias = sb[0];
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

// Backward of the forward: gz0, graw (B, n), the per-row partials (B, 2)
// (scratch) and dgain, dbias (1,) each; two launches on one stream.
extern "C" int nf_coupling_bwd(const void* gy, const void* gld, const void* z0, const void* raw,
                               const void* gain, const void* bias, void* gz0, void* graw,
                               void* partial, void* dgain, void* dbias, int B, int n,
                               void* stream) {
  if (n <= 0 || n % 4 != 0 || B < 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* p2 = static_cast<float2*>(partial);
  if (B > 0) {
    coupling_bwd_kernel<<<blocks_for(B), kThreads, 0, st>>>(
        static_cast<const float4*>(gy), static_cast<const float*>(gld),
        static_cast<const float4*>(z0), static_cast<const float4*>(raw),
        static_cast<const float*>(gain), static_cast<const float*>(bias),
        static_cast<float4*>(gz0), static_cast<float4*>(graw), p2, B, n / 4);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  reduce_partials_kernel<<<1, kReduceThreads, 0, st>>>(p2, B, static_cast<float*>(dgain),
                                                       static_cast<float*>(dbias));
  return (int)cudaGetLastError();
}
