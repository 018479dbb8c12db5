// The asynchronous copies the edge stages use, each behind one __device__
// helper: bulk copies from device to shared memory (the TMA's
// one-dimensional form, no tensor map) that complete on an mbarrier, the
// mbarrier's init, expected bytes, arrival and phase wait, and a prefetch
// into L2 (cp.async stays in csrc/mma_tf32.cuh).
// tests/test_torch_csrc_emulated.py supplies a C++ header of the same name
// (a copy is a copy, an mbarrier a barrier with its phase), so the kernels
// that include this file also run on the CPU.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// An mbarrier that completes a phase after `count` arrivals and the bytes
// they announced. mbar_fence_init() after the inits makes them visible to
// the copy engine.
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Announce `bytes` more to land on bar this phase, without arriving.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(bytes) : "memory");
}

// One arrival on bar, releasing the caller's earlier shared-memory stores.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}

// Wait until the phase of parity `parity` (0 first, then 1, 0, ...) of bar
// has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  const unsigned a = smem_u32(bar);
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
  }
}

// bytes (a multiple of 16; src and dst 16-byte aligned) from device to
// shared memory by the copy engine, counted against bar's phase.
__device__ __forceinline__ void bulk_copy_g2s(void* dst, const void* src,
                                              unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)), "l"(src), "r"(bytes),
      "r"(smem_u32(bar)) : "memory");
}

// Ask L2 for the line that holds p, without waiting for it or taking it
// into the SM.
__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}
