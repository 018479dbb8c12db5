// The PTX the kernels use, each behind one __device__ helper: TF32
// rounding, the warp-level m16n8k8 TF32 tensor-core product, and cp.async
// copies into shared memory. tests/test_torch_csrc_emulated.py supplies a
// C++ header of the same name with the same fragment layout, so the
// kernels that include this file also run on the CPU.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// x rounded to TF32 as cvt.rna does (to nearest, ties away from zero; the
// 13 low mantissa bits cleared), as its fp32 bit pattern.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// The 3xTF32 split x ~ hi + lo: hi = tf32(x), lo = tf32(x - hi). The
// products hi*hi + hi*lo + lo*hi keep about 2^-21 relative error.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// d += a b on one warp's fragments of a 16x8x8 product (PTX ISA,
// mma.m16n8k8 with .tf32 operands). With g = lane / 4 and t = lane % 4:
//   a (16x8, row-major): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   b (8x8, k by n):     b0 (t, g), b1 (t+4, g)
//   d (16x8, fp32):      d0 (g, 2t), d1 (g, 2t+1), d2 (g+8, 2t), d3 (g+8, 2t+1)
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Asynchronous copies of 4 and 16 bytes from device to shared memory;
// cp_async_wait_all() waits for this thread's copies.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
