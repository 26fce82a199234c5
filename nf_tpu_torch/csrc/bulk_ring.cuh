// mbarriers and 1-D bulk copies (cp.async.bulk, the TMA's 1-D form) for a
// weight ring in shared memory, Hopper (sm_90a).  Shared by the kernels that
// stream their weights through a ring filled by one producer warp:
// csrc/fused_stack_mma.cu and the ResFlow solve in csrc/fused_resflow.cu.
//
// The pattern: per slot a `full` barrier (count 1: the producer's
// arrive.expect_tx, completed by the copies' bytes) and an `empty` barrier
// (count: the consumer warps, one arrival each once they are done with the
// slot).  Use q of slot q % S waits on full with parity (q / S) & 1; the
// producer waits on empty with the opposite parity, which a fresh barrier
// passes at once.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ uint32_t shared_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(shared_addr(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the block's other threads and
// to the copy engine; __syncthreads() after it
__device__ __forceinline__ void bar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(shared_addr(bar)) : "memory");
}

// returns once the barrier's phase of parity `parity` has completed; a
// wait that outlasts 2^26 polls (over a second, against kernels of well
// under a millisecond) traps, so a lost arrival fails the launch instead
// of hanging the card
__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = shared_addr(bar);
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 26)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// one arrival that also announces `bytes` of bulk copies to come
__device__ __forceinline__ void bar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(shared_addr(bar)),
               "r"(bytes)
               : "memory");
}

// global -> shared, `bytes` a multiple of 16, both ends 16-byte aligned;
// completes on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(shared_addr(dst)),
      "l"(src), "r"(bytes), "r"(shared_addr(bar))
      : "memory");
}

}  // namespace
