// Hopper's warpgroup product (wgmma) as the fp32 node_proj uses it, each
// piece behind one __device__ helper: wgmma.mma_async m64n128k8 with fp32
// accumulators, TF32 A from registers and TF32 B from shared memory; the
// wait that leaves one committed group in flight; and the named barrier of
// one warpgroup. The descriptor, the fences, commit and the full wait are
// csrc/wgmma_bf16.cuh's. tests/test_torch_csrc_emulated.py supplies a C++
// header of the same name that computes the product from the descriptor by
// the PTX layout.
//
// A warpgroup is 4 warps; warp w holds rows 16 w .. 16 w + 15 of the 64.
// With g = lane / 4 and t = lane % 4 (the m16n8k8 TF32 layout within a
// warp), each register one TF32 value as its fp32 bit pattern:
//   a (16 x 8 a warp): a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4)
//   d (16 x 128 a warp): d[4i + u] at (g + 8 (u >> 1), 8 i + 2t + (u & 1))
// B (8 x 128) lies in shared memory K-major without swizzle: core matrices
// of 8 columns n by 4 k, each 8 rows (one per n) of 16 bytes; the two core
// matrices adjacent in k lie lbo bytes apart, those adjacent in n sbo bytes
// apart (the same geometry as a bf16 k16 step).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_bf16.cuh"

// wait until at most one of this warpgroup's committed groups is in flight
__device__ __forceinline__ void wgmma_wait1() {
  asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
}

// the 128 threads of warpgroup `wg` of the block meet (named barrier 1 + wg;
// barrier 0 is __syncthreads')
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
}

// d (+)= a b over k = 8: d = a b when accumulate is 0
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float* d, const uint32_t* a,
                                                     uint64_t desc, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}
