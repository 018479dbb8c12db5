// The bf16 helpers the bf16 edge stage uses, each behind one __device__
// function: rounding to bf16 as XLA's astype does it, and the warp-level
// m16n8k16 bf16 tensor-core product with fp32 accumulators.
// tests/test_torch_csrc_emulated.py supplies a C++ header of the same name
// with the same fragment layout, so the kernels that include this file
// also run on the CPU.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// x rounded to bf16 (to nearest, ties to even: __float2bfloat16_rn, never a
// truncation), as its 16 bits, and as an fp32 value.
__device__ __forceinline__ uint16_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// lo and hi rounded to bf16 and packed into one register, lo in the low 16
// bits: the pair (k, k+1) of an m16n8k16 operand fragment.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return static_cast<uint32_t>(bf16_bits(lo)) |
         (static_cast<uint32_t>(bf16_bits(hi)) << 16);
}

// d += a b on one warp's fragments of a 16x8x16 product (PTX ISA,
// mma.m16n8k16 with .bf16 operands, two per 32-bit register, the lower k
// in the low half). With g = lane / 4 and t = lane % 4:
//   a (16x16, row-major): a0 (g, 2t..2t+1), a1 (g+8, 2t..2t+1),
//                         a2 (g, 2t+8..2t+9), a3 (g+8, 2t+8..2t+9)
//   b (16x8, k by n):     b0 (2t..2t+1, g), b1 (2t+8..2t+9, g)
//   d (16x8, fp32):       d0 (g, 2t), d1 (g, 2t+1), d2 (g+8, 2t), d3 (g+8, 2t+1)
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
