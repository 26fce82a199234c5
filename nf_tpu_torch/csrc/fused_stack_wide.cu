// Whole-stack eval kernel for RealNVP / Glow density flows past one
// block's shared memory, Hopper (sm_90a): a thread block cluster.
//
// Replaces nf_tpu/ops/pallas/fused_stack.py::_make_kernels (fwd_kernel /
// inv_kernel) at the shapes where csrc/fused_stack.cuh's FFMA kernel does
// not fit one block even at 16 samples (fused_stack.py::ffma_plan
// 'ffma_cluster': RealNVP from D = 39 at F = 256, Glow from D = 37), and
// past its usual tiling at the widths where this kernel ran faster than
// its 16 samples (RealNVP from D = 213 at F = 32, Glow up to F = 128, from
// D = 63 at 128 and D = 111 at 32).  It computes what
// fused_stack.cuh computes (the math is stated there), forward or
// inverse, in ONE launch.
//
// Bound (H100 SXM, 67 TFLOP/s f32 on CUDA cores): per sample and coupling
// the conditioner's half*F + 4*F*F + 2*half*F multiply-adds and, for
// Glow, the mix's D*D; the weights and x / y cross device memory once.  At
// B = 1000 and 2 couplings that is 1.5-25 us (RealNVP) and 11-66 us (Glow
// at D = 400 / 1024).  What passes one block is D-wide: the x tile, the
// in-projection and head rows and the D x D mix (4 MB a coupling at D =
// 1024), which the first design of this path read from L2 per 16 samples
// with the x tile in device memory, on 63 blocks at B = 1000.
//
// Design.
//  * A cluster of kCluster = 4 blocks of 512 threads owns a tile of S
//    samples (48; fewer where shared memory asks:
//    fused_stack.py::wide_plan).  Member m keeps rows [m Dc, m Dc + Dc) of
//    the x tile, all S samples, in its shared memory (Dc = ceil(D / 4)
//    rounded up to 4).  With one block an SM an H100 holds 30 such
//    clusters at once, and a batch that needs more runs in waves: 48
//    samples keep B = 1000 to one wave of 21 clusters (84 blocks), where
//    32 samples made two; at B = 8,192 48 samples make 6 waves and 32
//    make 9, so the most samples that fit are taken at any batch.
//  * Past the D whose member rows fit shared memory at 16 samples (SPILL,
//    fused_stack.py 'ffma_cluster_spill'), each member's x tile, second x
//    buffer and s rows live in device memory instead (spill_floats a
//    member; the caller's scratch, mostly L2-resident), Glow's W^T rows are
//    read from L2 instead of the chunk ring, and a cluster keeps 48
//    samples: nothing left in shared memory grows with D, so every D
//    runs.
//  * The weights a member reads, its rows of W0 and of the head and the
//    conditioner's layers, stream through a ring of kSlots = 4 slots of 16
//    KB in shared memory: thread 0 issues TMA bulk copies (bulk_ring.cuh)
//    three chunks ahead, across phases and couplings, each slot completing
//    on its mbarrier, which thread 0 waits on; the block barrier that
//    follows passes the chunk on and frees the slot before it.  A chunk
//    carries a fixed cost of barrier and issue beside its work.  (Read
//    straight from L2 in the loops, the weights made every row wait on
//    L2's latency; cp.async by every thread was slower than the TMA.)
//  * In-projection h = W0 z1 + b0: each member forms the partial sum over
//    its own z1 rows for all S samples (F x S, tiles of 4 features x 4
//    samples); after a cluster barrier member m sums the 4 partials of
//    its own S / 4 samples through distributed shared memory, in member
//    order, and adds b0.
//  * The conditioner's four F x F layers then run on the member's S / 4
//    samples, TK x FP chunks of each layer from the ring, a thread's tile
//    one feature x 4 samples, so a weight is read from shared memory once
//    for 4 samples.  Its head input relu(h Ah + Bh) is gathered by every
//    member for all S samples after a second cluster barrier.
//  * Head and coupling: each member forms t and s for its own z0 rows and
//    all S samples (the head rows read once per S samples; a tile of one
//    row x 2 samples, its F products split over a lane pair and summed by
//    a shuffle), updates them and sums its rows' s per sample in row
//    order; the log-det sums the 4 members' shares in member order at the
//    end.
//  * Glow's mix, y = W x: member m forms its own rows for all S samples,
//    W^T's rows streamed in chunks of kMixRows = 16 through a two-slot
//    cp.async ring (each member reads its Dc columns of W^T, so a cluster
//    reads W once per S samples), x's rows of the chunk copied from their
//    owners through distributed shared memory one chunk ahead, into a
//    second x buffer; every member then swaps buffers.  A thread holds at
//    most kMixItems tiles of 4 rows x 4 samples: a member with more tiles
//    walks all of W^T once per kMixItems * 512 tiles (a pass).  Forward: after
//    the normalize (a cluster barrier, so every row is ready); inverse:
//    after the coupling, with the un-affine in the epilogue.
//  * Cluster barriers per coupling: RealNVP 2, Glow 3; one at the end
//    before the log-det sum and one before exit.  All products on the FFMA
//    units, in f32; accurate expf / tanhf (the results are held against
//    the plain PyTorch version).
//  * What holds it back at F = 256: each member streams all 4 F^2
//    conditioner weights (1 MB a coupling) for its 12 samples, 64 chunks
//    of that fixed cost; splitting the conditioner's output features over
//    the members (a quarter of the weights each, an all-gather a layer)
//    or the tensor cores are the next steps.
//  * F and D are run-time values (FP = F rounded up to 8, ..., 256; eight
//    instances: direction x mix x spill).  Members past D own no rows; a
//    ragged batch tail loads zeros and stores nothing.

#include <cooperative_groups.h>

#include "bulk_ring.cuh"
#include "fused_stack.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kCluster = 4;        // member blocks of a cluster
constexpr int kThreadsW = 512;     // threads of a member
constexpr int kSlots = 4;          // slots of the weight ring
constexpr int kSlotFloats = 4096;  // floats of a slot
constexpr int kMixRows = 16;       // rows of a mix chunk
constexpr int kMixItems = 2;       // mix tiles (4 rows x 4 samples) of a thread
constexpr int kInItems = 2;        // in-projection tiles (4 features x 4 samples) of a thread
constexpr int kSmP = 12;           // row stride of the conditioner's buffers (S / 4 <= 12)
constexpr int kCondItems = 2;      // conditioner tiles (1 feature x 4 samples) of a thread

// x rows of a member
__host__ __device__ constexpr int member_rows(int d) {
  return ((d + kCluster - 1) / kCluster + 3) & ~3;
}

// One member's shared memory, floats from its start (SP = S + 4, Sm = S /
// 4, Dc = member_rows(D)); fused_stack.py::smem_bytes mirrors it:
//   xa [Dc][SP] | xb [Dc][SP] (MIX) | hp [FP][SP]: in-projection partials,
//   then the gathered head input | sv [Dc / 2][SP]: the coupling's s | ha,
//   ua, ub [FP][kSmP]: the conditioner's h and activations | ring
//   [kSlots][kSlotFloats] | mring [2][16][Dc] (MIX) | mx [2][16][SP] (MIX)
//   | ldp [S] | the ring's kSlots mbarriers
// With `spill` xa, xb, sv and mring take no shared memory: xa | xb | sv
// lie in the member's spill_floats of device memory.
struct WideLayout {
  int sp, sm, dc, xa, xb, hp, sv, ha, ua, ub, ring, mring, mx, ldp, bars, size;
  __host__ __device__ constexpr WideLayout(int fp, int s, int d, bool mix, bool spill)
      : sp(s + 4), sm(s / kCluster), dc(member_rows(d)), xa(0),
        xb(xa + (spill ? 0 : dc * sp)), hp(xb + (mix && !spill ? dc * sp : 0)),
        sv(hp + fp * sp), ha(sv + (spill ? 0 : dc / 2 * sp)), ua(ha + fp * kSmP),
        ub(ua + fp * kSmP), ring(ub + fp * kSmP), mring(ring + kSlots * kSlotFloats),
        mx(mring + (mix && !spill ? 2 * kMixRows * dc : 0)),
        ldp(mx + (mix ? 2 * kMixRows * sp : 0)), bars(ldp + s), size(bars + 2 * kSlots) {}
};

// floats of one member's spilled x tile, second x buffer (MIX) and s rows
__host__ __device__ constexpr long long spill_floats(int s, int d, bool mix) {
  return (long long)((mix ? 2 : 1) * member_rows(d) + member_rows(d) / 2) * (s + 4);
}

__device__ __forceinline__ void sts4(float* p, const float4& v) {
  *reinterpret_cast<float4*>(p) = v;
}

template <bool INV, bool MIX, bool SPILL>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreadsW, 1)
    fused_stack_cluster_kernel(const Params prm, int FP, int S, float* __restrict__ spill) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int D = prm.D, half = (D + 1) / 2;
  const WideLayout lay(FP, S, D, MIX, SPILL);
  const int SP = lay.sp, Sm = lay.sm, Dc = lay.dc, DW = kCluster * Dc;
  const int m = (int)cluster.block_rank();
  const int r0 = m * Dc;                      // this member's first row
  const int nrows = max(0, min(Dc, D - r0));  // and its number of rows
  const int base = (int)(blockIdx.x / kCluster) * S;
  const int tid = threadIdx.x;
  const int TK = chunk_rows(FP), NCH = FP / TK, fq = FP / 4;
  // the x tile (the mix writes the other buffer, then swaps) and the s
  // rows: in shared memory, or in this member's spill
  const long long spill_n = SPILL ? spill_floats(S, D, MIX) : 0;
  float* const xg = SPILL ? spill + blockIdx.x * spill_n : nullptr;
  float* xcur = SPILL ? xg : smem + lay.xa;
  float* xoth = SPILL ? xg + Dc * SP : smem + lay.xb;
  float* hp = smem + lay.hp;
  float* svb = SPILL ? xg + (MIX ? 2 : 1) * Dc * SP : smem + lay.sv;
  float* ha = smem + lay.ha;
  float* ua = smem + lay.ua;
  float* ub = smem + lay.ub;
  float* ring = smem + lay.ring;
  float* ldp = smem + lay.ldp;
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem + lay.bars);

  // The weight stream: per walk step, the in-projection's rows of this
  // member's z1 rows (RI at a time), the conditioner's four layers (TK rows
  // at a time) and the head's t and s rows of its z0 rows (RH of each at a
  // time), chunk q in slot q % kSlots, copied by the TMA kSlots - 1 chunks
  // ahead and waited on the slot's mbarrier.
  // This member's z1 rows are k = r0 / 2 .. and its z0 rows i = r0 / 2 ..,
  // contiguous in w0t and wh.
  const int RI = kSlotFloats / FP, RH = kSlotFloats / 2 / FP;
  auto n_z1 = [&](int p) { return (nrows + p) >> 1; };
  auto n_z0 = [&](int p) { return (nrows + 1 - p) >> 1; };
  // The producer (thread 0) walks the stream with running counters and no
  // division (it is on the block's critical path: the next chunk's
  // barrier waits for its warp): the next chunk pq, its step, the phase
  // (0 in-projection, 1 conditioner, 2 head) and the rows or chunks of the
  // phase issued so far.
  int pq = 0, pstep = 0, pphase = 0, pdone = 0;
  auto issue_next = [&]() {
    if (pstep >= prm.n) return;
    const int c = INV ? prm.n - 1 - pstep : pstep, p = c & 1;
    const int n1 = n_z1(p), n0 = n_z0(p);
    if (pphase == 0 && pdone >= n1) pphase = 1, pdone = 0;
    if (pphase == 1 && pdone == 4 * NCH) pphase = 2, pdone = 0;
    float* dst = ring + (pq & (kSlots - 1)) * kSlotFloats;
    uint64_t* bar = bars + (pq & (kSlots - 1));
    if (pphase == 0) {  // w0t rows of z1 rows [pdone, pdone + RI)
      const uint32_t bytes = 4u * min(RI, n1 - pdone) * FP;
      bar_expect(bar, bytes);
      bulk_load(dst, prm.w0t + ((size_t)c * half + (r0 >> 1) + pdone) * FP, bytes, bar);
      pdone += RI;
    } else if (pphase == 1) {  // rows [pdone TK, pdone TK + TK) of the four layers
      bar_expect(bar, 4u * TK * FP);
      bulk_load(dst, prm.wrt + ((size_t)(c * 4) * FP + pdone * TK) * FP, 4u * TK * FP, bar);
      ++pdone;
    } else {  // the t rows, then the s rows, of z0 rows [pdone, pdone + RH)
      const float* wh = prm.wh + ((size_t)c * 2 * half + (r0 >> 1) + pdone) * FP;
      const uint32_t bytes = 4u * min(RH, n0 - pdone) * FP;
      bar_expect(bar, 2 * bytes);
      bulk_load(dst, wh, bytes, bar);
      bulk_load(dst + RH * FP, wh + (size_t)half * FP, bytes, bar);
      pdone += RH;
    }
    ++pq;
    if ((pphase == 2 && pdone >= n0) || (pphase == 1 && pdone == 4 * NCH && n0 == 0)) {
      pphase = pdone = 0;
      ++pstep;
    }
  };
  // the next chunk of the stream: thread 0 waits for it, then a barrier
  // passes it on (and every thread is done with the chunk before it, whose
  // slot the next copy takes, and the last phase's shared writes are
  // published)
  int qn = 0;
  auto take = [&]() {
    const int q = qn++;
    if (tid == 0) bar_wait(bars + (q & (kSlots - 1)), (q / kSlots) & 1);
    __syncthreads();
    if (tid == 0) issue_next();
    return ring + (q & (kSlots - 1)) * kSlotFloats;
  };

  // one F x F layer on the member's Sm samples: epi(f, s0, acc) for each
  // tile of one feature x 4 samples (acc[e] = sum_k W[k][f] in[k][s0 + e];
  // samples past Sm read the buffers' padding and are not stored), at most
  // kCondItems tiles a thread, four k at a time, the loads before the
  // multiply-adds
  const int cq = (Sm + 3) / 4;  // sample quads of a feature
  int cf[kCondItems], cs[kCondItems];
  bool con[kCondItems];
#pragma unroll
  for (int it = 0; it < kCondItems; ++it) {
    const int item = tid + it * kThreadsW;
    con[it] = item < FP * cq;
    cf[it] = item % FP;
    cs[it] = (item / FP) * 4;
  }
  auto layer = [&](const float* in, auto epi) {
    float acc[kCondItems][4];
#pragma unroll
    for (int it = 0; it < kCondItems; ++it)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[it][e] = 0.f;
    for (int ch = 0; ch < NCH; ++ch) {
      const float* w = take();
      const float* a_k = in + ch * TK * kSmP;
      for (int kk = 0; kk < TK; kk += 4) {
#pragma unroll
        for (int it = 0; it < kCondItems; ++it) {
          if (!con[it]) continue;
          float wv[4], a[4][4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            wv[u] = w[(kk + u) * FP + cf[it]];
            lds4(a[u], a_k + (kk + u) * kSmP + cs[it]);
          }
#pragma unroll
          for (int u = 0; u < 4; ++u)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[it][e] = fmaf(wv[u], a[u][e], acc[it][e]);
        }
      }
    }
#pragma unroll
    for (int it = 0; it < kCondItems; ++it)
      if (con[it]) epi(cf[it], cs[it], acc[it]);
  };

  // y = W x (forward) or W^-1 x, un-affine (inverse) on this member's rows,
  // into xoth; then the buffers swap.  W^T (D, DW) k-major, this member's
  // Dc columns from r0: chunks of kMixRows rows through the ring, or
  // (SPILL) read from L2 where they are used, a row past D as row D - 1
  // (its x is 0).
  auto mix = [&](int c, const float* pre) {
    float* mring = smem + lay.mring;
    float* mxs = smem + lay.mx;
    const float* wt = prm.mix + (size_t)c * D * DW + r0;
    const int rq = Dc / 4, sq = S / 4, items = rq * sq, nq = (D + kMixRows - 1) / kMixRows;
    constexpr int kPass = kMixItems * kThreadsW;
    cluster.sync();  // every member's rows are ready; none still reads the last mix's source
    auto issue_w = [&](int q) {
      if (SPILL) return;
      float* dst = mring + (q & 1) * kMixRows * Dc;
      for (int i = tid; i < kMixRows * rq; i += kThreadsW) {
        const int kk = i / rq, cc = (i - kk * rq) * 4, k = q * kMixRows + kk;
        if (k < D)
          __pipeline_memcpy_async(dst + kk * Dc + cc, wt + (size_t)k * DW + cc, 16);
        else
          sts4(dst + kk * Dc + cc, make_float4(0.f, 0.f, 0.f, 0.f));
      }
    };
    // x's rows of chunk q: one float4 of a thread (16 x S / 4 <= 256),
    // from the member that owns the row
    const int xi = tid < kMixRows * sq ? tid : -1;
    const int xk = xi < 0 ? 0 : xi / sq, xs = xi < 0 ? 0 : (xi - xk * sq) * 4;
    auto load_x = [&](int q) {
      const int k = q * kMixRows + xk;
      if (xi < 0 || k >= D) return make_float4(0.f, 0.f, 0.f, 0.f);
      const int owner = k / Dc;
      if (SPILL)  // from L2 (another SM wrote it), the owner's buffer: members swap together
        return __ldcg(reinterpret_cast<const float4*>(xcur + (owner - m) * spill_n +
                                                      (k - owner * Dc) * SP + xs));
      const float* src = cluster.map_shared_rank(xcur, owner);
      return *reinterpret_cast<const float4*>(src + (k - owner * Dc) * SP + xs);
    };
    for (int i0 = 0; i0 < items; i0 += kPass) {
      float acc[kMixItems][4][4];
#pragma unroll
      for (int it = 0; it < kMixItems; ++it)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[it][j][e] = 0.f;
      if (i0 > 0) __syncthreads();  // every thread is done with the last pass's rings
      issue_w(0);
      __pipeline_commit();
      float4 xv = load_x(0);
      if (xi >= 0) sts4(mxs + xk * SP + xs, xv);
      for (int q = 0; q < nq; ++q) {
        __pipeline_wait_prior(0);
        __syncthreads();  // chunk q has landed; every thread is done with chunk q - 1
        const bool more = q + 1 < nq;
        if (more) {
          issue_w(q + 1);
          xv = load_x(q + 1);
        }
        __pipeline_commit();
        const float* w = mring + (q & 1) * kMixRows * Dc;
        const float* x = mxs + (q & 1) * kMixRows * SP;
#pragma unroll
        for (int it = 0; it < kMixItems; ++it) {
          const int item = i0 + tid + it * kThreadsW;
          if (item >= items) continue;
          const int rr = (item % rq) * 4, s0 = (item / rq) * 4;
#pragma unroll 4
          for (int kk = 0; kk < kMixRows; ++kk) {
            float wv[4], a[4];
            if (SPILL) {
              const int k = min(q * kMixRows + kk, D - 1);
              const float4 w4 = __ldg(reinterpret_cast<const float4*>(wt + (size_t)k * DW + rr));
              wv[0] = w4.x, wv[1] = w4.y, wv[2] = w4.z, wv[3] = w4.w;
            } else {
              lds4(wv, w + kk * Dc + rr);
            }
            lds4(a, x + kk * SP + s0);
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[it][j][e] = fmaf(wv[j], a[e], acc[it][j][e]);
          }
        }
        if (more && xi >= 0) sts4(mxs + ((q + 1) & 1) * kMixRows * SP + xk * SP + xs, xv);
      }
#pragma unroll
      for (int it = 0; it < kMixItems; ++it) {
        const int item = i0 + tid + it * kThreadsW;
        if (item >= items) continue;
        const int rr = (item % rq) * 4, s0 = (item / rq) * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int g = r0 + rr + j;
          float4 v = make_float4(acc[it][j][0], acc[it][j][1], acc[it][j][2], acc[it][j][3]);
          if (INV) {
            const float sc = g < D ? pre[2 * g + 1] : 0.f, sh = g < D ? pre[2 * g] : 0.f;
            v = make_float4(v.x * sc + sh, v.y * sc + sh, v.z * sc + sh, v.w * sc + sh);
          }
          sts4(xoth + (rr + j) * SP + s0, v);
        }
      }
    }
    float* t = xcur;
    xcur = xoth;
    xoth = t;
  };

  if (tid == 0) {
    for (int i = 0; i < kSlots; ++i) bar_init(bars + i, 1);
    bar_init_fence();
  }
  __syncthreads();
  if (tid == 0)
    for (int q = 0; q < kSlots - 1; ++q) issue_next();
  for (int i = tid; i < S * Dc; i += kThreadsW) {
    const int s = i / Dc, r = i - s * Dc;
    xcur[r * SP + s] =
        (base + s < prm.B && r < nrows) ? prm.x[(size_t)(base + s) * D + r0 + r] : 0.f;
  }
  for (int s = tid; s < S; s += kThreadsW) ldp[s] = 0.f;
  __syncthreads();

  for (int step = 0; step < prm.n; ++step) {
    const int c = INV ? prm.n - 1 - step : step, p = c & 1;
    // forward (shift, scale) / inverse (shift, 1 / scale)
    const float* pre = prm.pre + (size_t)c * 2 * D;
    const float* vec = prm.vec + (size_t)c * kNVec * FP;

    if (!INV) {
      for (int i = tid; i < nrows * S; i += kThreadsW) {
        const int r = i / S, s = i - r * S, g = r0 + r;
        xcur[r * SP + s] = (xcur[r * SP + s] - pre[2 * g]) * pre[2 * g + 1];
      }
      if (MIX) mix(c, pre);
      __syncthreads();
    }

    // in-projection partials over this member's z1 rows (parity 1 - p),
    // all S samples: hp[f][s], tiles of 4 features x 4 samples, the rows
    // from the stream
    {
      const int items = fq * (S / 4), n1 = n_z1(p);
      float a[kInItems][4][4];
      int f0[kInItems], s0[kInItems];
#pragma unroll
      for (int it = 0; it < kInItems; ++it) {
        const int item = tid + it * kThreadsW;
        f0[it] = (item % fq) * 4;
        s0[it] = (item / fq) * 4;
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) a[it][j][e] = 0.f;
      }
      for (int k0 = 0; k0 < n1; k0 += RI) {
        const float* w = take();
        const int rows = min(RI, n1 - k0);
        for (int rr = 0; rr < rows; ++rr) {
          const float* xr = xcur + (2 * (k0 + rr) + 1 - p) * SP;
#pragma unroll
          for (int it = 0; it < kInItems; ++it) {
            if (tid + it * kThreadsW >= items) continue;
            float wv[4], xv[4];
            lds4(wv, w + rr * FP + f0[it]);
            lds4(xv, xr + s0[it]);
#pragma unroll
            for (int j = 0; j < 4; ++j)
#pragma unroll
              for (int e = 0; e < 4; ++e) a[it][j][e] = fmaf(wv[j], xv[e], a[it][j][e]);
          }
        }
      }
#pragma unroll
      for (int it = 0; it < kInItems; ++it) {
        if (tid + it * kThreadsW >= items) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j)
          sts4(hp + (f0[it] + j) * SP + s0[it],
               make_float4(a[it][j][0], a[it][j][1], a[it][j][2], a[it][j][3]));
      }
    }
    cluster.sync();  // every member's partials are written

    // h = sum of the 4 partials (member order) + b0 on this member's
    // samples [m Sm, m Sm + Sm); ua = relu(h A1 + B1); four elements' 32
    // remote loads in flight a thread
    for (int i0 = tid; i0 < FP * Sm; i0 += 4 * kThreadsW) {
      float parts[4][kCluster];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = min(i0 + u * kThreadsW, FP * Sm - 1), f = i / Sm;
#pragma unroll
        for (int j = 0; j < kCluster; ++j)
          parts[u][j] = cluster.map_shared_rank(hp, j)[f * SP + m * Sm + i - f * Sm];
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * kThreadsW, f = i / Sm, sl = i - f * Sm;
        if (i >= FP * Sm) continue;
        float a = 0.f;
#pragma unroll
        for (int j = 0; j < kCluster; ++j) a += parts[u][j];
        const float h = a + __ldg(vec + f);
        ha[f * kSmP + sl] = h;
        ua[f * kSmP + sl] = fmaxf(h * __ldg(vec + FP + f) + __ldg(vec + 2 * FP + f), 0.f);
      }
    }

    // two residual blocks: ua -> ub -> (h, ua), twice; then ua = the head's input
#pragma unroll 1
    for (int r = 0; r < 2; ++r) {
      const int o = 1 + 6 * r, na = r == 0 ? 7 : 13;
      layer(ua, [&](int f, int s0, const float (&acc)[4]) {
        const float b = __ldg(vec + (o + 2) * FP + f), A = __ldg(vec + (o + 3) * FP + f),
                    B = __ldg(vec + (o + 4) * FP + f);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (s0 + e < Sm) ub[f * kSmP + s0 + e] = fmaxf((acc[e] + b) * A + B, 0.f);
      });
      layer(ub, [&](int f, int s0, const float (&acc)[4]) {
        const float b = __ldg(vec + (o + 5) * FP + f), A = __ldg(vec + na * FP + f),
                    B = __ldg(vec + (na + 1) * FP + f);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (s0 + e >= Sm) continue;
          const float h = ha[f * kSmP + s0 + e] + (acc[e] + b);
          ha[f * kSmP + s0 + e] = h;
          ua[f * kSmP + s0 + e] = fmaxf(h * A + B, 0.f);
        }
      });
    }
    cluster.sync();  // every member's head input is written; the partials are read

    // gather the head input of all S samples into hp: sample s from member
    // s / Sm; eight copies in flight a thread
    if (Sm % 4 == 0) {
      const int q4 = Sm / 4, per_f = kCluster * q4, n = FP * per_f;
      for (int i0 = tid; i0 < n; i0 += 8 * kThreadsW) {
        float4 v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = i0 + u * kThreadsW;
          if (i >= n) continue;
          const int f = i / per_f, j = (i - f * per_f) / q4, e = (i - f * per_f - j * q4) * 4;
          v[u] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(ua, j) + f * kSmP + e);
        }
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const int i = i0 + u * kThreadsW;
          if (i >= n) continue;
          const int f = i / per_f, j = (i - f * per_f) / q4, e = (i - f * per_f - j * q4) * 4;
          sts4(hp + f * SP + j * Sm + e, v[u]);
        }
      }
    } else {
      for (int i = tid; i < FP * S; i += kThreadsW) {
        const int f = i / S, s = i - f * S, j = s / Sm;
        hp[f * SP + s] = cluster.map_shared_rank(ua, j)[f * kSmP + s - j * Sm];
      }
    }
    __syncthreads();

    // head and coupling on this member's z0 rows (parity p), tiles of one
    // row x 2 samples, each tile's K split over a lane pair and summed by a
    // shuffle, the rows from the stream: t = Wh[i] a + bh[i], s =
    // tanh(Wh[half + i] a + bh[half + i]) * gain + bias
    {
      const float* bh = prm.bh + (size_t)c * 2 * half;
      const float gain = prm.gb[2 * c], cbias = prm.gb[2 * c + 1];
      const int sq = S / 2, n0 = n_z0(p), kh = tid & 1, kw = FP / 2;
      for (int i0 = 0; i0 < n0; i0 += RH) {
        const float* w = take();
        const int n = 2 * min(RH, n0 - i0) * sq;  // even: whole lane pairs
        for (int item0 = 0; item0 < n; item0 += kThreadsW) {
          const int item = item0 + tid, pair = min(item, n - 1) >> 1;
          const int rr = pair / sq, s0 = (pair - rr * sq) * 2, il = i0 + rr, rl = 2 * il + p;
          const int i = (r0 >> 1) + il;
          const float* wt = w + rr * FP;
          const float* ws = w + (RH + rr) * FP;
          float at[2] = {0.f, 0.f}, as[2] = {0.f, 0.f};
          for (int k = kh * kw; k < kh * kw + kw; k += 4) {
            float tv[4], sv[4];
            lds4(tv, wt + k);
            lds4(sv, ws + k);
            float2 a[4];
#pragma unroll
            for (int kk = 0; kk < 4; ++kk)
              a[kk] = *reinterpret_cast<const float2*>(hp + (k + kk) * SP + s0);
#pragma unroll
            for (int kk = 0; kk < 4; ++kk) {
              at[0] = fmaf(tv[kk], a[kk].x, at[0]);
              at[1] = fmaf(tv[kk], a[kk].y, at[1]);
              as[0] = fmaf(sv[kk], a[kk].x, as[0]);
              as[1] = fmaf(sv[kk], a[kk].y, as[1]);
            }
          }
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            at[e] += __shfl_xor_sync(0xffffffffu, at[e], 1);
            as[e] += __shfl_xor_sync(0xffffffffu, as[e], 1);
          }
          if (item >= n || kh) continue;
          const float bt = bh[i], bs = bh[half + i];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float t = at[e] + bt;
            const float sv = tanhf(as[e] + bs) * gain + cbias;
            float* xr = xcur + rl * SP + s0 + e;
            *xr = INV ? (*xr - t) * expf(-sv) : *xr * expf(sv) + t;
            svb[il * SP + s0 + e] = sv;
          }
        }
      }
    }
    __syncthreads();
    // this member's share of the log-det: its rows' s, in row order
    for (int s = tid; s < S; s += kThreadsW) {
      float a = 0.f;
      for (int il = 0; 2 * il + p < nrows; ++il) a += svb[il * SP + s];
      ldp[s] += INV ? -a : a;
    }

    if (INV) {
      if (MIX) {
        mix(c, pre);
      } else {
        for (int i = tid; i < nrows * S; i += kThreadsW) {
          const int r = i / S, s = i - r * S, g = r0 + r;
          xcur[r * SP + s] = xcur[r * SP + s] * pre[2 * g + 1] + pre[2 * g];
        }
      }
      __syncthreads();
    }
  }

  cluster.sync();  // every member's share of the log-det is final
  for (int sl = tid; sl < Sm; sl += kThreadsW) {
    const int s = m * Sm + sl;
    if (base + s >= prm.B) continue;
    float a = 0.f;
#pragma unroll
    for (int j = 0; j < kCluster; ++j) a += cluster.map_shared_rank(ldp, j)[s];
    prm.ld[base + s] = a + prm.ld_const;
  }
  for (int i = tid; i < S * nrows; i += kThreadsW) {
    const int s = i / nrows, r = i - s * nrows;
    if (base + s < prm.B) prm.y[(size_t)(base + s) * D + r0 + r] = xcur[r * SP + s];
  }
  cluster.sync();  // no member exits while another reads its shared memory
}

template <bool INV, bool MIX, bool SPILL>
cudaError_t launch_cluster(const Params& prm, int fp, int samples, float* spill,
                           cudaStream_t stream) {
  const size_t smem = sizeof(float) * WideLayout(fp, samples, prm.D, MIX, SPILL).size;
  if (smem > 232448) return cudaErrorInvalidValue;
  auto kernel = fused_stack_cluster_kernel<INV, MIX, SPILL>;
  static size_t opted_in = 48 * 1024;  // above 48 KB a block needs the opt-in
  if (smem > opted_in) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    opted_in = smem;
  }
  const long long grid = (long long)((prm.B + samples - 1) / samples) * kCluster;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<(unsigned)grid, kThreadsW, smem, stream>>>(prm, fp, samples, spill);
  return cudaGetLastError();
}

template <bool INV>
cudaError_t launch_variant(const Params& prm, int fp, int samples, bool has_mix, float* spill,
                           cudaStream_t st) {
  if (has_mix)
    return spill ? launch_cluster<INV, true, true>(prm, fp, samples, spill, st)
                 : launch_cluster<INV, true, false>(prm, fp, samples, nullptr, st);
  return spill ? launch_cluster<INV, false, true>(prm, fp, samples, spill, st)
               : launch_cluster<INV, false, false>(prm, fp, samples, nullptr, st);
}

}  // namespace

// Plain C entry point: launches one direction on `stream` and returns the
// cudaError_t of the launch (0 on success).  fp: F padded to 8, 16, ...,
// 256; samples: fused_stack.py::wide_plan's samples a cluster (48, 32,
// 16, 8 or 4); `mix` (has_mix only): W^T (forward) or W^-T (inverse) per
// coupling, (n, D, 4 member_rows(D)) with the columns past D zero
// (fused_stack.py::cluster_mix); `spill`: null, or device memory of
// spill_floats(samples, D, has_mix) floats for each of the launch's
// 4 ceil(B / samples) blocks, which then keep their x tiles there.
extern "C" int nf_fused_stack_wide(const void* x, void* y, void* ld, const void* pre,
                                   const void* mix, const void* w0t, const void* vec,
                                   const void* wrt, const void* wh, const void* bh,
                                   const void* gb, void* spill, int B, int D, int n, int fp,
                                   int samples, int inverse, int has_mix, float ld_const,
                                   void* stream) {
  const bool fp_ok = fp == 8 || fp == 16 || fp == 32 || fp == 64 || fp == 128 || fp == 256;
  const bool s_ok = samples == 48 || samples == 32 || samples == 16 || samples == 8 ||
                    samples == 4;
  if ((has_mix && mix == nullptr) || !fp_ok || !s_ok || B <= 0 || D <= 0 ||
      fp / 4 * (samples / 4) > kInItems * kThreadsW ||
      fp * ((samples / kCluster + 3) / 4) > kCondItems * kThreadsW)
    return (int)cudaErrorInvalidValue;
  const Params prm = params_of(x, y, ld, pre, mix, w0t, vec, wrt, wh, bh, gb, B, D, n, ld_const);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* sp = static_cast<float*>(spill);
  return (int)(inverse ? launch_variant<true>(prm, fp, samples, has_mix != 0, sp, st)
                       : launch_variant<false>(prm, fp, samples, has_mix != 0, sp, st));
}
