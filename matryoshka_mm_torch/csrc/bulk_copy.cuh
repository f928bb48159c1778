// Hopper's bulk asynchronous copies (the copy engine behind TMA, used here
// without a tensor map: one request moves a contiguous run of bytes) and the
// shared-memory barriers (mbarrier) that report their completion.
//
//   global -> shared   bulk_load: completes on an mbarrier, which counts the
//                      bytes (expect_tx before the copies, one phase a fill)
//   shared -> global   bulk_store + bulk_commit: completes in bulk groups;
//                      bulk_wait_read<N> waits until at most N of the newest
//                      groups may still read their shared memory
//
// Both take an L2 cache policy (evict_first_policy: a stream read or written
// once).
// Sizes are multiples of 16 bytes, both addresses 16-byte aligned.
#pragma once

#include "common.cuh"

namespace m3 {

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   shared_addr(bar)),
               "r"(count));
}

// make the barriers' initialisation visible to the copy engine
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` more to land in this phase
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          shared_addr(bar)),
      "r"(bytes)
      : "memory");
}

// wait until the phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(shared_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// an L2 policy that evicts the lines it touches first
__device__ __forceinline__ uint64_t evict_first_policy() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n"
               : "=l"(policy));
  return policy;
}

__device__ __forceinline__ void bulk_load(void* smem, const void* gmem,
                                          unsigned bytes, uint64_t* bar,
                                          uint64_t policy) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      ".L2::cache_hint [%0], [%1], %2, [%3], %4;\n" ::"r"(shared_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(shared_addr(bar)), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void bulk_store(void* gmem, const void* smem,
                                           unsigned bytes, uint64_t policy) {
  asm volatile(
      "cp.async.bulk.global.shared::cta.bulk_group.L2::cache_hint"
      " [%0], [%1], %2, %3;\n" ::"l"(gmem),
      "r"(shared_addr(smem)), "r"(bytes), "l"(policy)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// every committed bulk group has completed (its writes are done)
__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

}  // namespace m3
