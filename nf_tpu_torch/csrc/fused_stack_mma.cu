// Whole-stack eval kernel for RealNVP / Glow density flows on the tensor
// cores, Hopper (sm_90a).
//
// Replaces nf_tpu/ops/pallas/fused_stack.py::_make_kernels (fwd_kernel /
// inv_kernel) in both variants, RealNVP and Glow (template MIX), for padded
// conditioner widths FP <= 64 and data dimensions D <= 8.  Wider stacks run
// the FFMA kernel of csrc/fused_stack.cuh; fused_stack.py::kernel_variant
// chooses by shape.  The math is fused_stack.cuh's (its header states it):
// per coupling a channel affine, Glow's D x D mix, the 6-layer MLP
// conditioner with four F x F layers, and the affine coupling, over n
// couplings in one launch, with every constant folded on the host
// (fused_stack.py::pack_stack, kernel_weights).
//
// Bound (H100 SXM): per sample and coupling in*F + 4*F*F + 2*out*F
// multiply-adds (4,192 at D = 2, F = 32) and about 22*F other f32
// operations, 2.4 GFLOP per direction at B = 8192, n = 32.  With the F x F
// products on the tensor cores in 3xTF32 (165 TFLOP/s for f32-accurate
// products) and the rest at 67 TFLOP/s that is about 0.013 ms; device
// memory moves under 1 MB.  Operations bound it.
//
// Design.
//  * A warp owns 16 samples (the M of mma.m16n8k8) for the whole walk over
//    the couplings.  Lane (g, t) = (lane / 4, lane % 4) holds features
//    8 j + 2 t and 8 j + 2 t + 1 (n-tile j) of samples g and g + 8: the C
//    fragment of every layer, FP / 2 floats.  The residual stream h stays
//    there from the in-projection to the head.
//  * The four F x F layers run on mma.sync.m16n8k8 TF32 in the 3xTF32
//    split of csrc/attention.cu (x = big + small, the small products
//    first).  The activations are the A side, split in registers per
//    k-step by truncation.  The weights are the B side, rounded to TF32
//    and split on the host, in B-fragment order [k-step][n-tile][lane]
//    [b0 big, b1 big, b0 small, b1 small]: one 16-byte load per lane and
//    (k-step, n-tile).
//  * A layer's C fragment is the next layer's A fragment with no shuffle
//    and no shared memory: k-step j's A fragment needs columns t and t + 4,
//    and the lane holds features 8 j + 2 t and 8 j + 2 t + 1.  So the host
//    permutes every layer's input rows within each group of 8 (position t
//    takes feature 8 j + 2 t, position t + 4 feature 8 j + 2 t + 1), and
//    the bias, batch-norm affine and ReLU epilogues run per lane on the
//    header's vectors at the lane's features.
//  * The small parts stay in registers, per quad (the 4 lanes of a group
//    g): the in-projection as an FFMA outer product, the head's 2 out rows
//    as per-lane partial dot products added over the quad by two xor
//    shuffles (all four lanes get the same bits), and the coupling's
//    tanh / exp / log-det, the channel affine and Glow's mix on the quad's
//    two samples, computed alike by its four lanes.  x and the log-det
//    live in registers from the first load to the last store.
//  * The weights stream through a ring of layer slots that the block's
//    four consumer warps share, filled by one producer warp with 1-D bulk
//    TMA copies (cp.async.bulk; csrc/bulk_ring.cuh) that complete on a
//    full mbarrier per slot; consumer warps wait on full barriers and
//    release empty ones, so warps never meet at a block barrier.  Up to
//    FP = 32 the ring holds two
//    couplings' layers and a step waits for its four at its start and
//    releases them at its end (no barrier instruction then orders the
//    loads inside a step, which measured faster on an H100 than a wait and
//    a release per layer); at FP = 64 it holds one coupling, waited for and
//    released per layer.  A coupling's header (vectors, in-projection,
//    head, norm, mix) travels through a two-slot ring of its own, filled a
//    coupling ahead.
//  * Blocks: 4 consumer warps (64 samples) and the producer, so B = 8192
//    is 128 blocks, one per SM, one warp per SM sub-partition.  ILP comes
//    from the FP / 8 independent n-tiles.
//  * Parity: the coupling's parity picks the rows of x it reads and
//    writes; the walk runs couplings in pairs with the parity a template
//    argument, so every index into x is known at compile time and x stays
//    in registers.
//  * Widths: FP in {8, 16, 32, 64}, DP in {2, 8}, zero-padded on the
//    host: padded features and dimensions stay exactly 0.  A ragged batch
//    tail loads zeros and stores nothing.
//  * Accurate expf / tanhf (no fast math): the results are held against
//    the plain PyTorch version.
//  * What bounds it (H100, B = 8192, F = 32): each warp's chain of
//    dependent work per coupling.  With one warp per sub-partition nothing
//    hides the fill and drain of each layer's mma chain, nor the head and
//    the coupling (shuffles, tanh, exp) that run serially between layers;
//    in builds without the small products the kernel saved far less than
//    those products' share of the HMMAs.  Three alternatives were
//    measured at FP = 32, DP = 2, came out slower and were not kept
//    (PERF.md has their times): f32 fragments split in registers (half
//    the shared-memory and L2 bytes, more ALU work per k-step), three
//    accumulators per tile (shorter mma chains, more registers and adds),
//    and wgmma over the block's warpgroup.

#include <cuda_runtime.h>

#include <cstdint>

#include "bulk_ring.cuh"

namespace {

constexpr int kWarps = 4;                    // consumer warps per block
constexpr int kSamples = 16 * kWarps;        // samples per block
constexpr int kThreads = 32 * (kWarps + 1);  // and one producer warp
constexpr int kNVec = 15;                    // per-coupling vectors, order as pack_stack's VEC
constexpr int kBarBytes = 256;               // the ring's mbarriers, ahead of the ring
constexpr unsigned kFull = 0xffffffffu;

struct Params {
  const float* x;     // (B, D)
  float* y;           // (B, D)
  float* ld;          // (B,)
  const float* hdr;   // (n, Header::kSize) this direction's headers, coupling order
  const float* frag;  // (n, 4, Layer::kSize) the F x F layers' B fragments
  int B, D, n;
  float ld_const;
};

// One coupling's header, floats from its start; fused_stack.py's
// MmaLayout mirrors this.  Rows are FP wide; t rows of the head first,
// its s rows from kHalf; pre is (shift, scale) forward, (shift, 1/scale)
// inverse; mix is W forward, W^-1 inverse, row-major (out, in).
template <int FP, int DP>
struct Header {
  static constexpr int kHalf = DP / 2;             // >= (D + 1) / 2
  static constexpr int kW0 = kNVec * FP;           // [kHalf][FP]
  static constexpr int kWh = kW0 + kHalf * FP;     // [2 kHalf][FP]
  static constexpr int kBh = kWh + 2 * kHalf * FP; // [2 kHalf]
  static constexpr int kGb = kBh + 2 * kHalf;      // [2] gain, bias
  static constexpr int kPre = kGb + 2;             // [DP][2]
  static constexpr int kMix = kPre + 2 * DP;       // [DP][DP]
  static constexpr int kSize = (kMix + DP * DP + 3) & ~3;
};

// One F x F layer's B fragments in shared memory: [k-step][n-tile][lane]
// [4] (b0 big, b1 big, b0 small, b1 small), split on the host
template <int FP>
struct Layer {
  static constexpr int kT = FP / 8;  // k-steps, and n-tiles
  static constexpr int kSize = kT * kT * 32 * 4;
};

// layer slots in the weight ring: two couplings' layers up to FP = 32
__host__ __device__ constexpr int ring_stages(int fp) { return fp <= 32 ? 8 : 4; }

// dynamic shared memory of one block; fused_stack.py::MmaLayout.smem_bytes mirrors this
template <int FP, int DP>
constexpr int smem_bytes() {
  return kBarBytes + 4 * (ring_stages(FP) * Layer<FP>::kSize + 2 * Header<FP, DP>::kSize);
}

// ---- 3xTF32 on mma.sync
// x = big + small, big = x truncated to TF32 (the activations, A side)
__device__ __forceinline__ void split_trunc(float x, uint32_t& big, uint32_t& small) {
  big = __float_as_uint(x) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc = u W for one F x F layer: u in the C layout of the layer before
// (u[j][r]: feature 8 j + 2 t + (r & 1) of sample g + 8 (r >> 1)), the
// fragments `frag` in shared memory.  k-step ks's A fragment is
// (u[ks][0], u[ks][2], u[ks][1], u[ks][3]): rows g, g + 8 at positions t
// (feature 8 ks + 2 t) and t + 4 (feature 8 ks + 2 t + 1).
template <int FP>
__device__ __forceinline__ void dense(const float* frag, const float (&u)[FP / 8][4],
                                      float (&acc)[FP / 8][4], int lane) {
  constexpr int T = FP / 8;
#pragma unroll
  for (int j = 0; j < T; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[j][r] = 0.f;
  const float* mine = frag + lane * 4;
#pragma unroll
  for (int ks = 0; ks < T; ++ks) {
    uint32_t ab[4], as[4];
    split_trunc(u[ks][0], ab[0], as[0]);
    split_trunc(u[ks][2], ab[1], as[1]);
    split_trunc(u[ks][1], ab[2], as[2]);
    split_trunc(u[ks][3], ab[3], as[3]);
    uint32_t bb[T][2], bs[T][2];
#pragma unroll
    for (int nt = 0; nt < T; ++nt) {
      const float4 w = *reinterpret_cast<const float4*>(mine + (ks * T + nt) * 32 * 4);
      bb[nt][0] = __float_as_uint(w.x);
      bb[nt][1] = __float_as_uint(w.y);
      bs[nt][0] = __float_as_uint(w.z);
      bs[nt][1] = __float_as_uint(w.w);
    }
    // the small products first, then big x big
#pragma unroll
    for (int nt = 0; nt < T; ++nt) mma(acc[nt], ab, bs[nt][0], bs[nt][1]);
#pragma unroll
    for (int nt = 0; nt < T; ++nt) mma(acc[nt], as, bb[nt][0], bb[nt][1]);
#pragma unroll
    for (int nt = 0; nt < T; ++nt) mma(acc[nt], ab, bb[nt][0], bb[nt][1]);
  }
}

// this lane's pair of a header row at n-tile j
__device__ __forceinline__ float2 pair(const float* row, int j, int t) {
  return *reinterpret_cast<const float2*>(row + 8 * j + 2 * t);
}

// out = relu(in * A + Bv) per lane, A / Bv header rows
template <int T>
__device__ __forceinline__ void bn_relu(float (&out)[T][4], const float (&in)[T][4],
                                        const float* A, const float* Bv, int t) {
#pragma unroll
  for (int j = 0; j < T; ++j) {
    const float2 a = pair(A, j, t), b = pair(Bv, j, t);
    out[j][0] = fmaxf(in[j][0] * a.x + b.x, 0.f);
    out[j][1] = fmaxf(in[j][1] * a.y + b.y, 0.f);
    out[j][2] = fmaxf(in[j][2] * a.x + b.x, 0.f);
    out[j][3] = fmaxf(in[j][3] * a.y + b.y, 0.f);
  }
}

template <int T>
__device__ __forceinline__ void add_bias(float (&v)[T][4], const float* bias, int t) {
#pragma unroll
  for (int j = 0; j < T; ++j) {
    const float2 b = pair(bias, j, t);
    v[j][0] += b.x;
    v[j][1] += b.y;
    v[j][2] += b.x;
    v[j][3] += b.y;
  }
}

// x[i] = M x[i] for the quad's two samples, M row-major DP x DP
template <int DP>
__device__ __forceinline__ void mix(float (&x)[2][DP], const float* M) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float v[DP];
#pragma unroll
    for (int d = 0; d < DP; ++d) {
      float a = 0.f;
#pragma unroll
      for (int k = 0; k < DP; ++k) a = fmaf(M[d * DP + k], x[i][k], a);
      v[d] = a;
    }
#pragma unroll
    for (int d = 0; d < DP; ++d) x[i][d] = v[d];
  }
}

template <int FP, int DP, bool INV, bool MIX>
struct Walk {
  using H = Header<FP, DP>;
  using L = Layer<FP>;
  static constexpr int T = FP / 8;
  static constexpr int S = ring_stages(FP);
  // with two couplings' slots in the ring, a step waits for its four
  // layers at its start and releases them at its end, so no barrier
  // instruction orders the loads inside a step
  static constexpr bool kHold = S >= 8;

  int D;             // data dimensions
  uint64_t* full;    // [S]
  uint64_t* empty;   // [S]
  uint64_t* hfull;   // [2]
  uint64_t* hempty;  // [2]
  const float* ring;
  const float* hdr;
  int lane, g, t;

  // layer q = 4 step + l from its ring slot (without kHold waited for and
  // released here)
  __device__ __forceinline__ void layer(int q, const float (&u)[T][4], float (&acc)[T][4]) const {
    const int slot = q % S;
    if (!kHold) bar_wait(&full[slot], (q / S) & 1);
    dense<FP>(ring + slot * L::kSize, u, acc, lane);
    if (!kHold) {
      __syncwarp();
      if (lane == 0) bar_arrive(&empty[slot]);
    }
  }

  // coupling `step` of the walk, parity P, on the quad's samples x, ld
  template <int P>
  __device__ __forceinline__ void step(int step, float (&x)[2][DP], float (&ld)[2]) const {
    const int hs = step & 1;
    bar_wait(&hfull[hs], (step >> 1) & 1);
    if (kHold) {
#pragma unroll
      for (int l = 0; l < 4; ++l) bar_wait(&full[(4 * step + l) % S], ((4 * step + l) / S) & 1);
    }
    const float* hd = hdr + hs * H::kSize;
    const float* vec = hd;
    const float* pre = hd + H::kPre;
    const int n_out = (D + 1 - P) / 2;

    if (!INV) {
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int d = 0; d < DP; ++d) x[i][d] = (x[i][d] - pre[2 * d]) * pre[2 * d + 1];
      if (MIX) mix<DP>(x, hd + H::kMix);
    }

    // in-projection h = W0 z1 + b0, z1 = rows 2k + 1 - P (zero weights past n_in)
    float h[T][4];
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const float2 b = pair(vec, j, t);
      h[j][0] = h[j][2] = b.x;
      h[j][1] = h[j][3] = b.y;
    }
#pragma unroll
    for (int k = 0; k < H::kHalf; ++k) {
      const float z0 = x[0][2 * k + 1 - P], z1 = x[1][2 * k + 1 - P];
#pragma unroll
      for (int j = 0; j < T; ++j) {
        const float2 w = pair(hd + H::kW0 + k * FP, j, t);
        h[j][0] = fmaf(w.x, z0, h[j][0]);
        h[j][1] = fmaf(w.y, z0, h[j][1]);
        h[j][2] = fmaf(w.x, z1, h[j][2]);
        h[j][3] = fmaf(w.y, z1, h[j][3]);
      }
    }

    // two residual blocks on the tensor cores
    float u[T][4], acc[T][4];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int o = 1 + 6 * r;
      bn_relu<T>(u, h, vec + o * FP, vec + (o + 1) * FP, t);
      layer(4 * step + 2 * r, u, acc);
      add_bias<T>(acc, vec + (o + 2) * FP, t);
      bn_relu<T>(u, acc, vec + (o + 3) * FP, vec + (o + 4) * FP, t);
      layer(4 * step + 2 * r + 1, u, acc);
      add_bias<T>(acc, vec + (o + 5) * FP, t);
#pragma unroll
      for (int j = 0; j < T; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) h[j][e] += acc[j][e];
    }
    bn_relu<T>(u, h, vec + 13 * FP, vec + 14 * FP, t);

    // head: row o of raw = wh[o] . u + bh[o] per sample, the lane's partial
    // dot product then the sum over the quad (lanes t ^ 1, then t ^ 2)
    const float gain = hd[H::kGb], cbias = hd[H::kGb + 1];
    float lsum[2] = {0.f, 0.f};
#pragma unroll
    for (int k = 0; k < H::kHalf; ++k) {
      if (k < n_out) {
        float raw[2][2];  // [t row, s row][sample]
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int o = k + e * H::kHalf;
          const float* w = hd + H::kWh + o * FP;
          float p0 = 0.f, p1 = 0.f;
#pragma unroll
          for (int j = 0; j < T; ++j) {
            const float2 wv = pair(w, j, t);
            p0 = fmaf(wv.x, u[j][0], p0);
            p0 = fmaf(wv.y, u[j][1], p0);
            p1 = fmaf(wv.x, u[j][2], p1);
            p1 = fmaf(wv.y, u[j][3], p1);
          }
          p0 += __shfl_xor_sync(kFull, p0, 1);
          p1 += __shfl_xor_sync(kFull, p1, 1);
          p0 += __shfl_xor_sync(kFull, p0, 2);
          p1 += __shfl_xor_sync(kFull, p1, 2);
          raw[e][0] = p0 + hd[H::kBh + o];
          raw[e][1] = p1 + hd[H::kBh + o];
        }
        // the coupling on row 2k + P
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float sv = tanhf(raw[1][i]) * gain + cbias;
          float& xr = x[i][2 * k + P];
          xr = INV ? (xr - raw[0][i]) * expf(-sv) : xr * expf(sv) + raw[0][i];
          lsum[i] += sv;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) ld[i] += INV ? -lsum[i] : lsum[i];

    if (INV) {
      if (MIX) mix<DP>(x, hd + H::kMix);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int d = 0; d < DP; ++d) x[i][d] = x[i][d] * pre[2 * d + 1] + pre[2 * d];
    }
    __syncwarp();
    if (lane == 0) {
      if (kHold) {
#pragma unroll
        for (int l = 0; l < 4; ++l) bar_arrive(&empty[(4 * step + l) % S]);
      }
      bar_arrive(&hempty[hs]);
    }
  }
};

template <int FP, int DP, bool INV, bool MIX>
__global__ void __launch_bounds__(kThreads, 1) fused_stack_mma_kernel(const Params prm) {
  using W = Walk<FP, DP, INV, MIX>;
  using H = typename W::H;
  using L = typename W::L;
  constexpr int S = W::S;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + S;
  uint64_t* hfull = empty + S;
  uint64_t* hempty = hfull + 2;
  float* ring = reinterpret_cast<float*>(smem + kBarBytes);
  float* hdr = ring + S * L::kSize;
  static_assert((2 * S + 4) * 8 <= kBarBytes, "the barriers outgrow their room");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int i = 0; i < S; ++i) {
      bar_init(&full[i], 1);
      bar_init(&empty[i], kWarps);
    }
    for (int i = 0; i < 2; ++i) {
      bar_init(&hfull[i], 1);
      bar_init(&hempty[i], kWarps);
    }
    bar_init_fence();
  }
  __syncthreads();

  const int n = prm.n;
  if (warp == kWarps) {
    // the producer: coupling step s's header, then its four layers, each
    // into its slot once the consumers have released it
    if (lane == 0) {
      for (int s = 0; s < n; ++s) {
        const int c = INV ? n - 1 - s : s;
        const int hs = s & 1;
        bar_wait(&hempty[hs], ((s >> 1) & 1) ^ 1);
        bar_expect(&hfull[hs], 4 * H::kSize);
        bulk_load(hdr + hs * H::kSize, prm.hdr + (size_t)c * H::kSize, 4 * H::kSize, &hfull[hs]);
        for (int l = 0; l < 4; ++l) {
          const int q = 4 * s + l, slot = q % S;
          bar_wait(&empty[slot], ((q / S) & 1) ^ 1);
          bar_expect(&full[slot], 4 * L::kSize);
          bulk_load(ring + slot * L::kSize, prm.frag + ((size_t)c * 4 + l) * L::kSize,
                    4 * L::kSize, &full[slot]);
        }
      }
    }
    return;
  }

  const int D = prm.D;
  const W walk{D, full, empty, hfull, hempty, ring, hdr, lane, lane >> 2, lane & 3};
  const int row0 = blockIdx.x * kSamples + warp * 16 + walk.g;
  const int rows[2] = {row0, row0 + 8};
  float x[2][DP], ld[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int d = 0; d < DP; ++d)
      x[i][d] = (rows[i] < prm.B && d < D) ? prm.x[(size_t)rows[i] * D + d] : 0.f;

  // couplings in pairs: forward c = 0, 1, ... (parities 0, 1); inverse
  // c = n - 1, n - 2, ... (parities 1, 0); n is even
  for (int s = 0; s < n; s += 2) {
    walk.template step<INV ? 1 : 0>(s, x, ld);
    walk.template step<INV ? 0 : 1>(s + 1, x, ld);
  }

  if (walk.t == 0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (rows[i] < prm.B) {
#pragma unroll
        for (int d = 0; d < DP; ++d)
          if (d < D) prm.y[(size_t)rows[i] * D + d] = x[i][d];
        prm.ld[rows[i]] = ld[i] + prm.ld_const;
      }
    }
  }
}

// Launches the variant on `stream`, or with blocks_per_sm set only reports
// how many of its blocks one SM holds at once.
template <int FP, int DP, bool INV, bool MIX>
cudaError_t launch(const Params& prm, cudaStream_t stream, int* blocks_per_sm) {
  constexpr int smem = smem_bytes<FP, DP>();
  auto kernel = fused_stack_mma_kernel<FP, DP, INV, MIX>;
  static bool opted_in = false;  // above 48 KB a block needs the opt-in
  if (!opted_in) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  if (blocks_per_sm != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, kThreads, smem);
  kernel<<<(prm.B + kSamples - 1) / kSamples, kThreads, smem, stream>>>(prm);
  return cudaGetLastError();
}

template <int FP, int DP>
cudaError_t launch_dir(const Params& prm, bool inverse, bool has_mix, cudaStream_t stream,
                       int* blocks_per_sm) {
  if (has_mix)
    return inverse ? launch<FP, DP, true, true>(prm, stream, blocks_per_sm)
                   : launch<FP, DP, false, true>(prm, stream, blocks_per_sm);
  return inverse ? launch<FP, DP, true, false>(prm, stream, blocks_per_sm)
                 : launch<FP, DP, false, false>(prm, stream, blocks_per_sm);
}

// The tilings: FP in {8, 16, 32, 64}, DP in {2, 8}.
cudaError_t dispatch(const Params& prm, int fp, int dp, bool inverse, bool has_mix,
                     cudaStream_t stream, int* blocks_per_sm) {
#define NF_TILING(FP_, DP_) \
  if (fp == FP_ && dp == DP_) return launch_dir<FP_, DP_>(prm, inverse, has_mix, stream, blocks_per_sm);
  NF_TILING(8, 2)
  NF_TILING(16, 2)
  NF_TILING(32, 2)
  NF_TILING(64, 2)
  NF_TILING(8, 8)
  NF_TILING(16, 8)
  NF_TILING(32, 8)
  NF_TILING(64, 8)
#undef NF_TILING
  return cudaErrorInvalidValue;
}

}  // namespace

// Plain C entry point: launches one direction on `stream` and returns the
// cudaError_t of the launch (0 on success).  (fp, dp) must be one of the
// tilings above, the weights laid out as fused_stack.py's MmaLayout lays
// them out; hdr is this direction's header array.
extern "C" int nf_fused_stack_mma(const void* x, void* y, void* ld, const void* hdr,
                                  const void* frag, int B, int D, int n, int fp, int dp,
                                  int inverse, int has_mix, float ld_const, void* stream) {
  if (B < 1 || D < 1 || D > dp || n < 2 || n % 2 != 0) return (int)cudaErrorInvalidValue;
  const Params prm{static_cast<const float*>(x), static_cast<float*>(y), static_cast<float*>(ld),
                   static_cast<const float*>(hdr), static_cast<const float*>(frag),
                   B, D, n, ld_const};
  return (int)dispatch(prm, fp, dp, inverse != 0, has_mix != 0, static_cast<cudaStream_t>(stream),
                       nullptr);
}

// Blocks of the tiling's kernel that one SM holds at once
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor, with the kernel's own
// threads and shared memory), into *blocks_per_sm.
extern "C" int nf_fused_stack_mma_blocks_per_sm(int fp, int dp, int inverse, int has_mix,
                                                int* blocks_per_sm) {
  if (blocks_per_sm == nullptr) return (int)cudaErrorInvalidValue;
  return (int)dispatch(Params{}, fp, dp, inverse != 0, has_mix != 0, nullptr, blocks_per_sm);
}
