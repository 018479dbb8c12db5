"""The CUDA sources under graingraphnn_torch/csrc/, compiled for the CPU
with g++ against a small emulation of the CUDA subset they use, against
their plain versions. This checks the kernels' logic (indexing, tiling,
tensor-core fragment layouts, the block-wide scans, the editor's control
flow) where there is no GPU; speed and the GPU compiler's view are checked
on the card only (tests/test_torch_cuda.py, chip_smoke.py).

Emulation: each block runs its threads as std::threads, one block after
the other; __syncthreads is a barrier, __syncwarp a barrier of the warp;
a warp shuffle or ballot
exchanges values through memory between two barriers of the warp.
Dynamic shared memory is a buffer of the launch's size. A grid has two
dimensions. csrc/mma_tf32.cuh is replaced by a C++ header of the same
name: TF32 rounding as cvt.rna does it, cp.async as a copy, and the
m16n8k8 product with the PTX fragment layout, its operands exchanged
through memory between two barriers of the warp; csrc/mma_bf16.cuh
likewise, on a bf16 type that rounds as __float2bfloat16_rn does, with
the m16n8k16 bf16 product; csrc/hopper_async.cuh by a header in which a
bulk copy is a copy made when it is issued and an mbarrier is a barrier
with its phase (arrivals and expected bytes count down, the
phase flips, a wait spins until the phase it names has completed);
csrc/wgmma_bf16.cuh by the warpgroup product computed from the shared-
memory descriptor the kernel builds, by the PTX layout. The
device reports 8 streaming multiprocessors, so grids sized by the SM
count take several tiles a block.
That is exact for these kernels, whose every thread reaches every
barrier, and every lane of a warp every shuffle, ballot and product."""

import ctypes
import dataclasses
import functools
import os
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
from graingraphnn_torch.kernels import _build, cell_update, edge_stage
from graingraphnn_torch.kernels import editor_fused
from graingraphnn_torch.models import cells
from graingraphnn_torch.ops import period_conv
from graingraphnn_torch.rollout import device_driver as dd
from graingraphnn_torch.rollout import topology_jit as tj

EMU_H = r"""
#pragma once
#include <math.h>
#include <stdint.h>
#include <string.h>
#include <algorithm>
#include <barrier>
#include <memory>
#include <thread>
#include <vector>
using std::max;
using std::min;
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx;
inline thread_local std::barrier<>* emu_warp_bar = nullptr;
inline thread_local std::barrier<>* emu_wg_bar = nullptr;   // of 128 threads
inline dim3 blockDim, gridDim;
inline std::barrier<>* emu_bar = nullptr;
inline std::vector<int64_t>* emu_x = nullptr;
inline std::vector<uint32_t>* emu_frag = nullptr;
inline unsigned char* emu_dyn_smem = nullptr;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) alignas(n)
typedef void* cudaStream_t;
struct float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) { return {x, y, z, w}; }
struct float2 { float x, y; };
inline float2 make_float2(float x, float y) { return {x, y}; }
struct int2 { int x, y; };
inline int2 make_int2(int x, int y) { return {x, y}; }
struct int4 { int x, y, z, w; };
inline int4 make_int4(int x, int y, int z, int w) { return {x, y, z, w}; }
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1,
                   cudaErrorMisalignedAddress = 716 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
constexpr int EMU_SMS = 8;   // so that grids sized by SMs walk several tiles
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = EMU_SMS;
  return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
template <class F> cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute, int) {
  return cudaSuccess;
}
// the emulated SM holds one block of any size
template <class F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 1;
  return cudaSuccess;
}
inline void __syncthreads() { emu_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_warp_bar->arrive_and_wait(); }
template <class T> T emu_pull(T v, int src) {
  int64_t b = 0;
  memcpy(&b, &v, sizeof(T));
  (*emu_x)[threadIdx.x] = b;
  emu_warp_bar->arrive_and_wait();
  int64_t r = (*emu_x)[src];
  emu_warp_bar->arrive_and_wait();
  T out;
  memcpy(&out, &r, sizeof(T));
  return out;
}
template <class T> T __shfl_xor_sync(unsigned, T v, int o) {
  return emu_pull(v, threadIdx.x ^ o);
}
template <class T> T __shfl_up_sync(unsigned, T v, int d) {
  const int lane = threadIdx.x & 31;
  return emu_pull(v, lane >= d ? (int)threadIdx.x - d : (int)threadIdx.x);
}
template <class T> T __shfl_sync(unsigned, T v, int src) {
  return emu_pull(v, (int)(threadIdx.x & ~31u) + (src & 31));
}
inline unsigned __ballot_sync(unsigned, int p) {
  const unsigned w0 = threadIdx.x & ~31u;
  (*emu_x)[threadIdx.x] = p != 0;
  emu_warp_bar->arrive_and_wait();
  unsigned r = 0;
  for (unsigned l = 0; l < 32 && w0 + l < blockDim.x; ++l)
    r |= (unsigned)((*emu_x)[w0 + l] != 0) << l;
  emu_warp_bar->arrive_and_wait();
  return r;
}
inline int __ffs(int x) { return __builtin_ffs(x); }
inline uint32_t __float_as_uint(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  return u;
}
inline float __uint_as_float(uint32_t u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}
// bf16 as cuda_bf16.h has it: __float2bfloat16_rn rounds to nearest, ties
// to even (a NaN stays a quiet NaN)
struct __nv_bfloat16 { uint16_t x; };
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(uint16_t)((u >> 16) | 0x40u)};
  return {(uint16_t)((u + 0x7fffu + ((u >> 16) & 1u)) >> 16)};
}
inline float __bfloat162float(__nv_bfloat16 b) {
  const uint32_t u = (uint32_t)b.x << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline unsigned short __bfloat16_as_ushort(__nv_bfloat16 b) { return b.x; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
// the rounded single operations (built with -ffp-contract=off, so never fused)
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
inline int atomicSub(int* p, int v) {
  return __atomic_fetch_sub(p, v, __ATOMIC_SEQ_CST);
}
inline int atomicMin(int* p, int v) {
  int old = __atomic_load_n(p, __ATOMIC_SEQ_CST);
  while (v < old && !__atomic_compare_exchange_n(p, &old, v, false,
                                                 __ATOMIC_SEQ_CST, __ATOMIC_SEQ_CST)) {
  }
  return old;
}
template <class F, class... A>
void emu_launch(F kernel, dim3 grid, dim3 block, size_t smem, A... args) {
  gridDim = grid;
  blockDim = block;
  for (unsigned b = 0; b < grid.x * grid.y; ++b) {
    std::barrier<> bar(block.x);
    std::vector<std::unique_ptr<std::barrier<>>> warp_bars, wg_bars;
    for (unsigned w = 0; w < block.x; w += 32)
      warp_bars.emplace_back(new std::barrier<>(std::min(32u, block.x - w)));
    for (unsigned w = 0; w < block.x; w += 128)
      wg_bars.emplace_back(new std::barrier<>(std::min(128u, block.x - w)));
    std::vector<int64_t> x(block.x);
    std::vector<uint32_t> frag(6 * block.x);
    std::vector<double> dyn(smem / sizeof(double) + 2);
    emu_bar = &bar;
    emu_x = &x;
    emu_frag = &frag;
    emu_dyn_smem = reinterpret_cast<unsigned char*>(dyn.data());
    std::vector<std::thread> ts;
    for (unsigned t = 0; t < block.x; ++t)
      ts.emplace_back([&, t] {
        threadIdx = dim3(t);
        blockIdx = dim3(b % grid.x, b / grid.x);
        emu_warp_bar = warp_bars[t / 32].get();
        emu_wg_bar = wg_bars[t / 128].get();
        kernel(args...);
      });
    for (auto& th : ts) th.join();
  }
}
"""

# csrc/mma_tf32.cuh for the emulation: the same helpers in C++; the product
# reads the TF32 bits of its operands, as the tensor cores do.
EMU_MMA_H = r"""
#pragma once
#include "emu.h"
// cvt.rna.tf32.f32: to nearest, ties away from zero, 13 low bits cleared
inline uint32_t to_tf32(float x) {
  uint32_t u;
  memcpy(&u, &x, 4);
  if ((u & 0x7f800000u) != 0x7f800000u) u += 0x1000u;
  return u & 0xffffe000u;
}
inline float emu_f(uint32_t u) {
  float f;
  memcpy(&f, &u, 4);
  return f;
}
inline void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - emu_f(hi));
}
// mma.m16n8k8.row.col.f32.tf32.tf32.f32; g = lane / 4, t = lane % 4:
// a0 (g, t), a1 (g+8, t), a2 (g, t+4), a3 (g+8, t+4); b0 (t, g), b1 (t+4, g);
// d0 (g, 2t), d1 (g, 2t+1), d2 (g+8, 2t), d3 (g+8, 2t+1)
inline void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  const int lane = threadIdx.x & 31, w0 = threadIdx.x - lane;
  uint32_t* mine = &(*emu_frag)[6 * threadIdx.x];
  for (int i = 0; i < 4; ++i) mine[i] = a[i];
  mine[4] = b[0];
  mine[5] = b[1];
  emu_warp_bar->arrive_and_wait();
  // the tensor cores read each operand's TF32 bits: the 13 below ignored
  auto frag = [&](int l, int reg) {
    return emu_f((*emu_frag)[6 * (w0 + l) + reg] & 0xffffe000u);
  };
  auto A = [&](int r, int k) { return frag(4 * (r & 7) + (k & 3), (r >= 8) + 2 * (k >= 4)); };
  auto B = [&](int k, int n) { return frag(4 * n + (k & 3), 4 + (k >= 4)); };
  const int g = lane >> 2, t = lane & 3;
  float out[4];
  for (int u = 0; u < 4; ++u) {
    const int r = g + 8 * (u >> 1), n = 2 * t + (u & 1);
    float s = 0.f;
    for (int k = 0; k < 8; ++k) s += A(r, k) * B(k, n);
    out[u] = d[u] + s;
  }
  emu_warp_bar->arrive_and_wait();
  for (int u = 0; u < 4; ++u) d[u] = out[u];
}
inline void cp_async4(void* smem, const void* gmem) { memcpy(smem, gmem, 4); }
inline void cp_async16(void* smem, const void* gmem) { memcpy(smem, gmem, 16); }
inline void cp_async_wait_all() {}
"""


# csrc/mma_bf16.cuh for the emulation: the same helpers in C++ on the bf16
# type of emu.h, and the m16n8k16 bf16 product, its operands exchanged
# through memory as the TF32 one's.
EMU_MMA_BF16_H = r"""
#pragma once
#include "emu.h"
inline uint16_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
inline float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
inline uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)bf16_bits(lo) | ((uint32_t)bf16_bits(hi) << 16);
}
// mma.m16n8k16.row.col.f32.bf16.bf16.f32; g = lane / 4, t = lane % 4, two
// values a register, the lower k in the low half:
// a0 (g, 2t..), a1 (g+8, 2t..), a2 (g, 2t+8..), a3 (g+8, 2t+8..);
// b0 (2t.., g), b1 (2t+8.., g); d0 (g, 2t), d1 (g, 2t+1), d2 (g+8, 2t),
// d3 (g+8, 2t+1)
inline void mma_bf16(float* d, const uint32_t* a, const uint32_t* b) {
  const int lane = threadIdx.x & 31, w0 = threadIdx.x - lane;
  uint32_t* mine = &(*emu_frag)[6 * threadIdx.x];
  for (int i = 0; i < 4; ++i) mine[i] = a[i];
  mine[4] = b[0];
  mine[5] = b[1];
  emu_warp_bar->arrive_and_wait();
  auto half = [&](int l, int reg, int hi) {
    const uint32_t w = (*emu_frag)[6 * (w0 + l) + reg];
    return __bfloat162float({(uint16_t)(hi ? w >> 16 : w & 0xffffu)});
  };
  auto A = [&](int r, int k) {
    return half(4 * (r & 7) + ((k & 7) >> 1), (r >= 8) + 2 * (k >= 8), k & 1);
  };
  auto B = [&](int k, int n) { return half(4 * n + ((k & 7) >> 1), 4 + (k >= 8), k & 1); };
  const int g = lane >> 2, t = lane & 3;
  float out[4];
  for (int u = 0; u < 4; ++u) {
    const int r = g + 8 * (u >> 1), n = 2 * t + (u & 1);
    float s = 0.f;
    for (int k = 0; k < 16; ++k) s += A(r, k) * B(k, n);
    out[u] = d[u] + s;
  }
  emu_warp_bar->arrive_and_wait();
  for (int u = 0; u < 4; ++u) d[u] = out[u];
}
"""


# csrc/hopper_async.cuh for the emulation. A bulk copy is a memcpy when
# issued (stopping the process where the PTX's alignment rule is broken),
# its bytes counted off the mbarrier at once; an
# mbarrier is a phase bit, the arrivals still due and the bytes still
# expected (which may run below zero until announced), kept in a table
# under one lock and keyed by its shared-memory address. A wait sleeps on
# the mbarrier's condition variable, which each completed phase wakes, so
# that the threads waiting on a ring's stages leave the cores to those at
# work.
EMU_ASYNC_H = r"""
#pragma once
#include <stdio.h>
#include <stdlib.h>
#include <chrono>
#include <condition_variable>
#include <map>
#include <mutex>
#include "emu.h"
struct EmuMbar {
  unsigned count, due, phase;
  long tx;
  std::condition_variable done;
};
inline std::mutex emu_mbar_mu;
inline std::map<const void*, EmuMbar> emu_mbars;
inline void emu_mbar_settle(EmuMbar& b) {
  if (b.due == 0 && b.tx == 0) {
    b.phase ^= 1u;
    b.due = b.count;
    b.done.notify_all();
  }
}
inline void mbar_init(uint64_t* bar, unsigned count) {
  std::lock_guard<std::mutex> l(emu_mbar_mu);
  EmuMbar& b = emu_mbars[bar];
  b.count = b.due = count;
  b.phase = 0u;
  b.tx = 0;
}
inline void mbar_fence_init() {}
inline void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  std::lock_guard<std::mutex> l(emu_mbar_mu);
  emu_mbars.at(bar).tx += bytes;
}
inline void mbar_arrive(uint64_t* bar) {
  std::lock_guard<std::mutex> l(emu_mbar_mu);
  EmuMbar& b = emu_mbars.at(bar);
  b.due -= 1;
  emu_mbar_settle(b);
}
// a phase that never completes is a fault of the kernel: stop after 30 s
inline void mbar_wait(uint64_t* bar, unsigned parity) {
  std::unique_lock<std::mutex> l(emu_mbar_mu);
  EmuMbar& b = emu_mbars.at(bar);
  if (!b.done.wait_for(l, std::chrono::seconds(30),
                       [&] { return b.phase != parity; })) {
    fprintf(stderr, "mbar_wait: phase %u never completed\n", parity);
    abort();
  }
}
inline void prefetch_l2(const void*) {}
// the PTX's rule: both ends 16-byte aligned, a multiple of 16 bytes
inline void bulk_copy_g2s(void* dst, const void* src, unsigned bytes,
                          uint64_t* bar) {
  if ((((uintptr_t)dst | (uintptr_t)src | bytes) & 15u) != 0) {
    fprintf(stderr, "bulk_copy_g2s: %p <- %p, %u bytes, not 16-byte aligned\n",
            dst, src, bytes);
    abort();
  }
  memcpy(dst, src, bytes);
  std::lock_guard<std::mutex> l(emu_mbar_mu);
  EmuMbar& b = emu_mbars.at(bar);
  b.tx -= bytes;
  emu_mbar_settle(b);
}
"""


# csrc/wgmma_bf16.cuh for the emulation. The descriptor holds the B
# tile's offset in the dynamic shared memory; the product reads B from
# there by the PTX's K-major layout without swizzle (element (k, n) in the
# core matrix (n / 8, k / 8), sbo and lbo bytes apart, at byte 16 (n % 8)
# + 2 (k % 8) of it) and A from the four warps' fragments, exchanged
# through memory between two barriers of the block (a node_proj_bf16 block
# is one warpgroup).
EMU_WGMMA_H = r"""
#pragma once
#include <stdio.h>
#include <stdlib.h>
#include "emu.h"
inline uint64_t wgmma_desc(const void* smem, unsigned lbo, unsigned sbo) {
  const unsigned a = (unsigned)((const unsigned char*)smem - emu_dyn_smem);
  return (uint64_t)((a & 0x3FFFF) >> 4) | (uint64_t)((lbo & 0x3FFFF) >> 4) << 16 |
         (uint64_t)((sbo & 0x3FFFF) >> 4) << 32;
}
inline void wgmma_fence() {}
inline void wgmma_commit() {}
inline void wgmma_wait0() {}
inline void wgmma_m64n128k16(float* d, const uint32_t* a, uint64_t desc,
                             int accumulate) {
  if (blockDim.x != 128) {
    fprintf(stderr, "wgmma: the emulation takes blocks of one warpgroup\n");
    abort();
  }
  uint32_t* mine = &(*emu_frag)[6 * threadIdx.x];
  for (int i = 0; i < 4; ++i) mine[i] = a[i];
  emu_bar->arrive_and_wait();
  const unsigned char* base = emu_dyn_smem + ((desc & 0x3FFFu) << 4);
  const unsigned lbo = ((desc >> 16) & 0x3FFFu) << 4, sbo = ((desc >> 32) & 0x3FFFu) << 4;
  auto B = [&](int k, int n) {
    uint16_t h;
    memcpy(&h, base + (n / 8) * sbo + (k / 8) * lbo + (n % 8) * 16 + (k % 8) * 2, 2);
    return __bfloat162float({h});
  };
  auto A = [&](int row, int k) {
    const int r = row % 16, lane = 4 * (r & 7) + ((k & 7) >> 1);
    const uint32_t w = (*emu_frag)[6 * (32 * (row / 16) + lane) + (r >= 8) + 2 * (k >= 8)];
    return __bfloat162float({(uint16_t)(k & 1 ? w >> 16 : w & 0xffffu)});
  };
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  float out[64];
  for (int i = 0; i < 16; ++i)
    for (int u = 0; u < 4; ++u) {
      const int row = 16 * warp + g + 8 * (u >> 1), col = 8 * i + 2 * t + (u & 1);
      float s = 0.f;
      for (int k = 0; k < 16; ++k) s += A(row, k) * B(k, col);
      out[4 * i + u] = (accumulate ? d[4 * i + u] : 0.f) + s;
    }
  emu_bar->arrive_and_wait();
  for (int i = 0; i < 64; ++i) d[i] = out[i];
}
"""


# csrc/wgmma_tf32.cuh for the emulation, over the emulated wgmma_bf16.cuh
# (its descriptor, fences and waits). The product reads B from the
# descriptor's offset by the PTX's K-major layout without swizzle (element
# (k, n) in the core matrix (n / 8, k / 4), sbo and lbo bytes apart, at
# byte 16 (n % 8) + 4 (k % 4) of it) and A from the warpgroup's four warps'
# fragments (each register a TF32 value's fp32 bits), exchanged through
# memory between two barriers of the warpgroup, so a block may hold
# several warpgroups that run apart; the named barrier of a warpgroup is
# that barrier.
EMU_WGMMA_TF32_H = r"""
#pragma once
#include "emu.h"
#include "wgmma_bf16.cuh"
inline void wgmma_wait1() {}
inline void wg_sync(int) { emu_wg_bar->arrive_and_wait(); }
inline void wgmma_m64n128k8_tf32(float* d, const uint32_t* a, uint64_t desc,
                                 int accumulate) {
  const int wt = threadIdx.x % 128, w0 = threadIdx.x - wt;
  uint32_t* mine = &(*emu_frag)[6 * threadIdx.x];
  for (int i = 0; i < 4; ++i) mine[i] = a[i];
  emu_wg_bar->arrive_and_wait();
  const unsigned char* base = emu_dyn_smem + ((desc & 0x3FFFu) << 4);
  const unsigned lbo = ((desc >> 16) & 0x3FFFu) << 4, sbo = ((desc >> 32) & 0x3FFFu) << 4;
  auto B = [&](int k, int n) {
    float v;
    memcpy(&v, base + (n / 8) * sbo + (k / 4) * lbo + (n % 8) * 16 + (k % 4) * 4, 4);
    return v;
  };
  auto A = [&](int row, int k) {
    const int r = row % 16, lane = 4 * (r & 7) + (k & 3);
    const uint32_t w = (*emu_frag)[6 * (w0 + 32 * (row / 16) + lane) + (r >= 8) + 2 * (k >= 4)];
    float v;
    memcpy(&v, &w, 4);
    return v;
  };
  const int warp = wt / 32, lane = wt % 32;
  const int g = lane >> 2, t = lane & 3;
  float out[64];
  for (int i = 0; i < 16; ++i)
    for (int u = 0; u < 4; ++u) {
      const int row = 16 * warp + g + 8 * (u >> 1), col = 8 * i + 2 * t + (u & 1);
      float s = 0.f;
      for (int k = 0; k < 8; ++k) s += A(row, k) * B(k, col);
      out[4 * i + u] = (accumulate ? d[4 * i + u] : 0.f) + s;
    }
  emu_wg_bar->arrive_and_wait();
  for (int i = 0; i < 64; ++i) d[i] = out[i];
}
"""


def _translate(src: str) -> str:
    """`k<<<grid, block, smem, stream>>>(args)`, k a name or `name<args>`,
    -> `emu_launch(k, grid, block, smem, args)`; `extern __shared__ T
    name[];` -> a pointer to the launch's dynamic shared memory; the CUDA
    runtime header -> the emulation header."""
    src = src.replace("#include <cuda_runtime.h>", '#include "emu.h"')
    src = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?(\w+) (\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(emu_dyn_smem);", src)
    out, i = [], 0
    while (j := src.find("<<<", i)) >= 0:
        name_start = j
        if src[j - 1] == ">":                 # template arguments
            name_start = src.rindex("<", 0, j)
        while name_start > 0 and (src[name_start - 1].isalnum()
                                  or src[name_start - 1] == "_"):
            name_start -= 1
        k = src.find(">>>(", j)
        parts, depth, cur = [], 0, ""
        for ch in src[j + 3:k]:
            depth += ch in "(<"
            depth -= ch in ")>"
            if ch == "," and depth == 0:
                parts.append(cur)
                cur = ""
            else:
                cur += ch
        parts.append(cur)
        smem = parts[2] if len(parts) > 2 else "0"
        out += [src[i:name_start], f"emu_launch({src[name_start:j]}, "
                f"{parts[0]}, {parts[1]}, {smem}, "]
        i = k + 4
    return "".join(out) + src[i:]


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    """build(source, symbol, argtypes, defines) -> the C entry of a CPU
    build of csrc/<source>.cu, built once per (source, defines): dlopen
    would hand back the code already loaded from a rebuilt path."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ with C++20")
    d = tmp_path_factory.mktemp("csrc_emu")
    (d / "emu.h").write_text(EMU_H)
    (d / "mma_tf32.cuh").write_text(EMU_MMA_H)
    (d / "mma_bf16.cuh").write_text(EMU_MMA_BF16_H)
    (d / "hopper_async.cuh").write_text(EMU_ASYNC_H)
    (d / "wgmma_bf16.cuh").write_text(EMU_WGMMA_H)
    (d / "wgmma_tf32.cuh").write_text(EMU_WGMMA_TF32_H)
    libs = {}

    def build(source, symbol, argtypes, defines=()):
        key = (source, tuple(defines))
        if key not in libs:
            so = d / f"lib{source}{len(libs)}.so"
            with open(os.path.join(_build.CSRC, source + ".cu")) as f:
                (d / f"{source}.cpp").write_text(_translate(f.read()))
            subprocess.run(
                ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-shared",
                 "-fPIC", "-pthread", f"-I{d}", *[f"-D{x}" for x in defines],
                 "-o", str(so), str(d / f"{source}.cpp")],
                check=True, capture_output=True, timeout=600)
            libs[key] = ctypes.CDLL(str(so))
        fn = getattr(libs[key], symbol)
        fn.argtypes, fn.restype = list(argtypes), ctypes.c_int

        def call(*args):
            assert fn(*args) == 0

        call.raw = fn                  # returns the entry's error code
        return call

    build.dir = d
    return build


@pytest.mark.parametrize("G,C,K,Ns,Nd,Fs,Fd", [
    (4, 8, 3, 40, 37, 19, 17), (4, 8, 16, 37, 21, 17, 19),
    (1, 16, 3, 30, 33, 11, 8), (4, 96, 16, 29, 5, 107, 104)])
def test_edge_stage_source_matches_plain(emulated, G, C, K, Ns, Nd, Fs, Fd):
    fn = emulated(edge_stage.SOURCE, "edge_stage_forward",
                  edge_stage._ARGTYPES)
    rng = np.random.default_rng(K + Nd)
    conv = period_conv.PeriodConv(Fs, Fd, C, G)
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(torch.from_numpy(
                rng.normal(0, 0.3, p.shape).astype(np.float32)))
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    xs = t(rng.uniform(0, 1, (Ns, Fs)).astype(np.float32))
    xd = t(rng.uniform(0, 1, (Nd, Fd)).astype(np.float32))
    nbr = t(rng.integers(0, Ns, (Nd, K)).astype(np.int32))
    ln = t(rng.uniform(0, 0.3, (Nd, K)).astype(np.float32))
    mask = (rng.uniform(size=(Nd, K)) < 0.7).astype(np.float32)
    mask[::4] = 0.0
    mask = t(mask)
    out = edge_stage.launch(fn, 0, conv, xs, xd, nbr, ln, mask, G, C)
    ref = period_conv.apply_period_conv_plain(conv, xs, xd, nbr, ln, mask,
                                              num_gates=G, out_channels=C)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("G,C,K,cap,Fs,Fd", [(4, 8, 3, 24, 19, 17),
                                            (4, 8, 16, 20, 17, 19)])
def test_edge_stage_source_on_halo_tables(emulated, G, C, K, cap, Fs, Fd):
    """The halo stripes' layout (parallel.halo): 3 * cap source rows
    [left | local | right], cap destination rows, indices into all three
    parts; node_proj and edge_attn launched alone and fused, against the
    plain versions."""
    fns = [emulated(edge_stage.SOURCE, sym, args) for sym, args in (
        ("edge_stage_forward", edge_stage._ARGTYPES),
        ("edge_node_proj", edge_stage._PROJ_ARGTYPES),
        ("edge_attn_forward", edge_stage._ATTN_ARGTYPES))]
    conv, rng = _random_conv(cap + K, Fs, Fd, G, C)
    xs = torch.from_numpy(rng.uniform(0, 1, (3 * cap, Fs)).astype(np.float32))
    xd = torch.from_numpy(rng.uniform(0, 1, (cap, Fd)).astype(np.float32))
    nbr = rng.integers(0, 3 * cap, (cap, K)).astype(np.int32)
    nbr[:, 0] = np.arange(cap) % 3 * cap + np.arange(cap)   # every part
    nbr = torch.from_numpy(nbr)
    ln = torch.from_numpy(rng.uniform(0, 0.3, (cap, K)).astype(np.float32))
    mask = torch.from_numpy((rng.uniform(size=(cap, K)) < 0.8)
                            .astype(np.float32))
    kw = dict(num_gates=G, out_channels=C)
    ref = period_conv.apply_period_conv_plain(conv, xs, xd, nbr, ln, mask,
                                              **kw)
    out = edge_stage.launch(fns[0], 0, conv, xs, xd, nbr, ln, mask, G, C)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    proj = edge_stage.launch_node_proj(fns[1], 0, conv, xs, xd)
    for o, r in zip(proj, period_conv.node_projections_plain(conv, xs, xd)):
        torch.testing.assert_close(o, r, atol=1e-4, rtol=1e-4)
    out = edge_stage.launch_edge_attn(fns[2], 0, conv, xs, xd, nbr, ln, mask,
                                      proj, G, C)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


def _random_conv(seed, Fs, Fd, G, C):
    rng = np.random.default_rng(seed)
    conv = period_conv.PeriodConv(Fs, Fd, C, G)
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(torch.from_numpy(
                rng.normal(0, 0.3, p.shape).astype(np.float32)))
    return conv, rng


def _node_proj_case(G, C, Ns, Nd, Fs, Fd, branch, lead=0):
    return pytest.param(G, C, Ns, Nd, Fs, Fd, branch, lead,
                        id="-".join(map(str, (G, C, Ns, Nd, Fs, Fd)))
                        + (f"-lead{lead}" if lead else ""))


@pytest.mark.parametrize("G,C,Ns,Nd,Fs,Fd,branch,lead", [
    # the rollout's widths, ragged row tiles, 2-3 tiles a block
    _node_proj_case(4, 96, 70, 131, 107, 104, "persistent"),
    _node_proj_case(4, 32, 1, 65, 104, 107, "one_wave"),   # one source row
    # G*C not a multiple of 4, one dest row
    _node_proj_case(1, 30, 37, 1, 19, 8, "one_wave"),
    # F of 8 and 11: rows of 32 and 44 bytes; 2-3 tiles a warpgroup, so
    # each stage is refilled and its mbarrier goes round its phases
    _node_proj_case(4, 96, 200, 330, 8, 11, "persistent"),
    _node_proj_case(4, 96, 330, 200, 11, 8, "persistent"),
    _node_proj_case(2, 16, 50, 20, 11, 104, "one_wave"),
    # one wave on blocks of two and of three warpgroups
    _node_proj_case(4, 32, 100, 150, 107, 104, "one_wave"),
    _node_proj_case(4, 32, 300, 290, 104, 104, "one_wave"),
    _node_proj_case(4, 96, 300, 130, 107, 104, "persistent"),
    # x's base 4 and 8 bytes past a 16-byte boundary
    _node_proj_case(4, 96, 70, 131, 107, 104, "persistent", lead=1),
    _node_proj_case(2, 16, 50, 20, 11, 104, "one_wave", lead=2),
])
def test_node_proj_source_matches_plain(emulated, G, C, Ns, Nd, Fs, Fd,
                                        branch, lead):
    """The grouped 3xTF32 node projections against their plain version:
    F not a multiple of 8 (nor of 4: rows not 16-byte aligned), N not a
    multiple of the 64-row tile, Ns != Nd, x at any 4-byte offset; each
    case on the grid the launcher picks for the emulated 8-SM card (one
    wave of a tile a warpgroup, on blocks of one, two or three warpgroups,
    or persistent blocks of three), asserted through edge_stage's branch
    counter."""
    fn = emulated(edge_stage.SOURCE, "edge_node_proj",
                  edge_stage._PROJ_ARGTYPES)
    conv, rng = _random_conv(Ns + Nd, Fs, Fd, G, C)

    def rows(n, f):
        a = torch.from_numpy(rng.uniform(0, 1, n * f + 4).astype(np.float32))
        return a[lead:lead + n * f].view(n, f)

    xs, xd = rows(Ns, Fs), rows(Nd, Fd)
    assert xs.data_ptr() % 16 == 4 * lead
    edge_stage.reset_counts()
    out = edge_stage.launch_node_proj(fn, 0, conv, xs, xd)
    assert edge_stage.node_proj_branches == {
        b: int(b == branch) for b in edge_stage.BRANCHES}
    ref = period_conv.node_projections_plain(conv, xs, xd)
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, atol=1e-4, rtol=1e-4)


def _scattered_mask(rng, Nd, K):
    """Random live slots, with every 5th row from the first fully masked,
    every 5th from the second fully live, and the even slots of every 5th
    from the third masked, so live slots do not form a prefix."""
    mask = (rng.uniform(size=(Nd, K)) < 0.6).astype(np.float32)
    mask[::5] = 0.0
    mask[1::5] = 1.0
    mask[2::5, ::2] = 0.0
    return mask


def _attn_case(G, C, K, Ns, Nd, Fs, Fd, scattered, branch, id):
    return pytest.param(G, C, K, Ns, Nd, Fs, Fd, scattered, branch, id=id)


@pytest.mark.parametrize("G,C,K,Ns,Nd,Fs,Fd,scattered,branch", [
    _attn_case(4, 8, 3, 13, 11, 11, 9, False, "one_wave", "3-11"),
    _attn_case(4, 8, 16, 13, 4, 11, 9, False, "one_wave", "16-4"),
    # the rollout's widths; 197 rows are 3+ row tiles with a ragged last one
    _attn_case(4, 96, 3, 70, 197, 107, 104, True, "persistent", "rollout-K3"),
    _attn_case(4, 96, 16, 90, 37, 104, 107, True, "persistent", "rollout-K16"),
    _attn_case(1, 30, 16, 20, 23, 11, 9, True, "one_wave", "G1-C30"),
    _attn_case(2, 128, 5, 30, 41, 19, 8, True, "one_wave", "C128"),
    # past 8 waves of one-gate blocks (the emulated card's 8 SMs), blocks
    # of all G gates, 2-3 tiles each, so every stage of both rings is
    # refilled and its mbarriers go round their phases; ragged last tiles
    _attn_case(4, 96, 3, 150, 300, 107, 104, True, "persistent",
               "persistent-K3-C96"),
    _attn_case(4, 48, 16, 150, 281, 104, 107, True, "persistent",
               "persistent-K16-C48"),
    _attn_case(4, 32, 24, 120, 270, 104, 107, True, "persistent",
               "persistent-K24-C32"),
    _attn_case(4, 64, 64, 90, 270, 104, 107, True, "persistent",
               "persistent-K64-C64"),
    # G = 3 at C = 128, K = 64: one gate a block in one wave (each block's
    # single tile gathered and multiplied by all its warps); past 8 waves
    # two gates fit a block, so the gate groups are 2 + 1
    _attn_case(3, 128, 64, 40, 30, 104, 107, True, "one_wave",
               "one-wave-G3-C128-K64"),
    _attn_case(3, 128, 64, 40, 350, 104, 107, True, "persistent",
               "persistent-G3-C128-K64"),
])
def test_edge_attn_source_matches_plain(emulated, G, C, K, Ns, Nd, Fs, Fd,
                                        scattered, branch):
    """The edge kernel alone on the plain node projections: gates of
    width not a multiple of 8 and up to 128, rows with no live slot, with
    all K live, and with live slots scattered over the row; each case on
    the grid the launcher picks for the emulated 8-SM card (one wave of a
    (tile, gate) a block, or persistent blocks of several tiles, of one
    gate or of a group of gates), asserted through edge_stage's branch
    counter."""
    fn = emulated(edge_stage.SOURCE, "edge_attn_forward",
                  edge_stage._ATTN_ARGTYPES)
    conv, rng = _random_conv(K if not scattered else K + C + Nd, Fs, Fd, G, C)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    xs = t(rng.uniform(0, 1, (Ns, Fs)).astype(np.float32))
    xd = t(rng.uniform(0, 1, (Nd, Fd)).astype(np.float32))
    nbr = t(rng.integers(0, Ns, (Nd, K)).astype(np.int32))
    ln = t(rng.uniform(0, 0.3, (Nd, K)).astype(np.float32))
    if scattered:
        mask = _scattered_mask(rng, Nd, K)
    else:
        mask = (rng.uniform(size=(Nd, K)) < 0.7).astype(np.float32)
        mask[::3] = 0.0
    mask = t(mask)
    proj = period_conv.node_projections_plain(conv, xs, xd)
    edge_stage.reset_counts()
    out = edge_stage.launch_edge_attn(fn, 0, conv, xs, xd, nbr, ln, mask,
                                      proj, G, C)
    assert edge_stage.edge_attn_branches == {
        b: int(b == branch) for b in edge_stage.BRANCHES}
    ref = period_conv.edge_attn_plain(conv, xs, xd, nbr, ln, mask, proj,
                                      num_gates=G, out_channels=C)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("K", [17, 24, 32, 64])
def test_edge_attn_source_wide_rings(emulated, K):
    """Pull rings past 16 slots, as the host engine sizes them from the
    live degree (8-wide buckets, and 17, which it never asks for), at the
    rollout's widths: scattered live slots, rows whose live slots all lie
    past slot 31 or only in the last slot, fully live and fully masked
    rows. The fused conv and the edge kernel alone against their plain
    versions."""
    G, C, Ns, Nd, Fs, Fd = 4, 96, 90, 37, 104, 107
    conv, rng = _random_conv(K + 1000, Fs, Fd, G, C)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    xs = t(rng.uniform(0, 1, (Ns, Fs)).astype(np.float32))
    xd = t(rng.uniform(0, 1, (Nd, Fd)).astype(np.float32))
    nbr = t(rng.integers(0, Ns, (Nd, K)).astype(np.int32))
    ln = t(rng.uniform(0, 0.3, (Nd, K)).astype(np.float32))
    mask = _scattered_mask(rng, Nd, K)
    mask[3] = 0.0
    mask[3, K // 2:] = 1.0          # live slots past slot 31 at K = 64
    mask[4] = 0.0
    mask[4, K - 1] = 1.0            # one live slot, the last
    mask = t(mask)
    proj = period_conv.node_projections_plain(conv, xs, xd)
    attn = emulated(edge_stage.SOURCE, "edge_attn_forward",
                    edge_stage._ATTN_ARGTYPES)
    out = edge_stage.launch_edge_attn(attn, 0, conv, xs, xd, nbr, ln, mask,
                                      proj, G, C)
    ref = period_conv.edge_attn_plain(conv, xs, xd, nbr, ln, mask, proj,
                                      num_gates=G, out_channels=C)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)
    fused = emulated(edge_stage.SOURCE, "edge_stage_forward",
                     edge_stage._ARGTYPES)
    out = edge_stage.launch(fused, 0, conv, xs, xd, nbr, ln, mask, G, C)
    ref = period_conv.apply_period_conv_plain(conv, xs, xd, nbr, ln, mask,
                                              num_gates=G, out_channels=C)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=1e-4)


def test_edge_attn_source_refuses_rings_past_64(emulated):
    """K = 65 is past the kernel's widest ring: the wrapper's check and the
    C entry both refuse it (no fallback to the plain version)."""
    G, C, K, N, F = 1, 8, 65, 5, 8
    with pytest.raises(ValueError, match="K<=64"):
        edge_stage._limits(F, F, G, C, K)
    fn = emulated(edge_stage.SOURCE, "edge_attn_forward",
                  edge_stage._ATTN_ARGTYPES)
    conv, rng = _random_conv(0, F, F, G, C)
    x = torch.from_numpy(rng.uniform(0, 1, (N, F)).astype(np.float32))
    nbr = torch.zeros((N, K), dtype=torch.int32)
    f = torch.ones((N, K))
    proj = period_conv.node_projections_plain(conv, x, x)
    codes = []
    edge_stage.launch_edge_attn(lambda *a: codes.append(fn.raw(*a)), 0, conv,
                                x, x, nbr, f, f, proj, G, C)
    assert codes[0] != 0


def test_edge_attn_source_refuses_wide_gates(emulated):
    """C = 129 is past the kernel's widest gate: the wrapper's check and
    the C entry both refuse it."""
    G, C, K, N, F = 1, 129, 3, 5, 8
    with pytest.raises(ValueError, match="C<=128"):
        edge_stage._limits(F, F, G, C, K)
    fn = emulated(edge_stage.SOURCE, "edge_attn_forward",
                  edge_stage._ATTN_ARGTYPES)
    conv, rng = _random_conv(0, F, F, G, C)
    x = torch.from_numpy(rng.uniform(0, 1, (N, F)).astype(np.float32))
    nbr = torch.zeros((N, K), dtype=torch.int32)
    f = torch.ones((N, K))
    proj = period_conv.node_projections_plain(conv, x, x)
    codes = []
    edge_stage.launch_edge_attn(lambda *a: codes.append(fn.raw(*a)), 0, conv,
                                x, x, nbr, f, f, proj, G, C)
    assert codes[0] != 0


# the bf16 kernels against their plain bf16 versions: the same roundings,
# fp32 sums in another order, so now and then the bf16 rounding of one
# logit product, relu value or alpha flips and moves a gate's row; the
# mean is held tight and the max loose (chip_smoke's limits). Readings
# here: means 3.4e-9 to 2.0e-6 of the scale, maxima up to 1.1e-3; the fp32
# conv against the plain bf16 version reads 8.1e-4 in the mean
BF16_MEAN, BF16_MAX = 1e-5, 1e-2


def _bf16_close(out, ref):
    err, scale = (out - ref).abs(), float(ref.abs().max())
    assert bool(torch.isfinite(out).all())
    assert float(err.mean()) <= BF16_MEAN * scale, float(err.mean()) / scale
    assert float(err.max()) <= BF16_MAX * scale, float(err.max()) / scale
    return float(err.mean()) / scale


def test_bf16_emulation_rounds_as_torch(emulated):
    """The emulation's __float2bfloat16_rn (csrc/mma_bf16.cuh's bf16_bits
    on it) against torch's float -> bfloat16 conversion, both to nearest
    with ties to even: random values over many binades, exact ties both
    ways, subnormals, zeros and infinities."""
    src = emulated.dir / "round.cpp"
    src.write_text('#include "mma_bf16.cuh"\n'
                   'extern "C" void round_all(const float* x, uint16_t* y, '
                   'int n) { for (int i = 0; i < n; ++i) y[i] = '
                   'bf16_bits(x[i]); }\n')
    so = emulated.dir / "libround.so"
    subprocess.run(["g++", "-std=c++20", "-shared", "-fPIC",
                    f"-I{emulated.dir}", "-o", str(so), str(src)],
                   check=True, capture_output=True, timeout=120)
    fn = ctypes.CDLL(str(so)).round_all
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
    rng = np.random.default_rng(0)
    ties = (np.arange(1 << 12, dtype=np.uint32) << 16 | 0x8000).view(
        np.float32)
    x = np.concatenate([
        rng.normal(0, 1, 4096) * np.exp2(rng.integers(-130, 120, 4096)),
        ties, -ties, [0.0, -0.0, np.inf, -np.inf, 1e-45, 3.4e38]]
    ).astype(np.float32)
    y = np.empty(x.shape, np.uint16)
    fn(x.ctypes.data, y.ctypes.data, x.size)
    want = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    np.testing.assert_array_equal(y, want.view(np.uint16))


def _bf16_entries(emulated, defines=()):
    """The emulated C entries of csrc/edge_stage_bf16.cu: {"conv",
    "node_proj", "edge_attn": entry}."""
    return {which: emulated(edge_stage.SOURCE_BF16, sym,
                            edge_stage.ARGTYPES["bf16"][which], defines)
            for which, sym in edge_stage.ENTRIES["bf16"][1].items()}


@pytest.mark.parametrize("G,C,K,Ns,Nd,Fs,Fd", [
    pytest.param(4, 8, 3, 13, 11, 11, 9, id="K3-oddF"),
    pytest.param(1, 30, 16, 20, 23, 11, 9, id="K16-C30"),
    pytest.param(2, 20, 33, 30, 41, 19, 8, id="K33"),
    # the rollout's widths; 197 rows are 3+ row tiles with a ragged last one
    pytest.param(4, 96, 3, 70, 197, 107, 104, id="rollout-K3"),
    pytest.param(4, 96, 16, 90, 37, 104, 107, id="rollout-K16"),
    pytest.param(1, 128, 5, 66, 9, 128, 3, id="C128-F128"),
    # node_proj_bf16's persistent blocks: 64 t + 13 rows, several tiles a
    # block (two blocks a slice over 4 source tiles), F = 107 at its
    # 428-byte stride (the ragged tile ends 3 values past a 16-byte block)
    pytest.param(4, 96, 3, 64 * 3 + 13, 64 * 2 + 13, 107, 104,
                 id="persistent-ragged"),
    # pull with masked rows, fully live rows past the first chunk of 8,
    # and at K = 40 a second ballot
    pytest.param(4, 96, 16, 141, 64 + 13, 104, 107, id="pull-K16"),
    pytest.param(4, 96, 40, 90, 37, 104, 107, id="pull-K40"),
])
def test_edge_stage_bf16_source_matches_plain(emulated, G, C, K, Ns, Nd, Fs,
                                              Fd):
    """csrc/edge_stage_bf16.cu's three entries against the plain bf16
    versions: node_proj_bf16 alone (F odd, or 3, so F - 3 is no multiple
    of 16; N not a multiple of the 64-row tile; blocks that walk several
    tiles), edge_attn_bf16 alone on the plain projections and the fused
    conv, with fully masked rows, fully live rows and scattered live
    slots, K = 3, 16, 33 and 40 (two ballots)."""
    entries = _bf16_entries(emulated)
    conv, rng = _random_conv(K + Nd + C, Fs, Fd, G, C)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    xs = t(rng.uniform(0, 1, (Ns, Fs)).astype(np.float32))
    xd = t(rng.uniform(0, 1, (Nd, Fd)).astype(np.float32))
    nbr = t(rng.integers(0, Ns, (Nd, K)).astype(np.int32))
    ln = t(rng.uniform(0, 0.3, (Nd, K)).astype(np.float32))
    mask = t(_scattered_mask(rng, Nd, K))
    kw = dict(num_gates=G, out_channels=C, precision="bf16")
    proj = edge_stage.launch_node_proj(entries["node_proj"], 0, conv, xs, xd,
                                       "bf16")
    ref = period_conv.node_projections_plain(conv, xs, xd, "bf16")
    for o, r in zip(proj, ref):
        torch.testing.assert_close(o, r, atol=1e-5, rtol=1e-5)
    out = edge_stage.launch_edge_attn(entries["edge_attn"], 0, conv, xs, xd,
                                      nbr, ln, mask, ref, G, C, "bf16")
    _bf16_close(out, period_conv.edge_attn_plain(conv, xs, xd, nbr, ln, mask,
                                                 ref, **kw))
    # a fully masked row is its skip projection alone
    torch.testing.assert_close(out[0], ref[3][0], atol=0, rtol=0)
    out = edge_stage.launch(entries["conv"], 0, conv, xs, xd, nbr, ln, mask,
                            G, C, "bf16")
    _bf16_close(out, period_conv.apply_period_conv_plain(conv, xs, xd, nbr,
                                                         ln, mask, **kw))
    torch.testing.assert_close(out[0], proj[3][0], atol=0, rtol=0)


def test_fp32_source_fails_the_bf16_limits(emulated):
    """The planted fault: the fp32 conv's output held against the plain
    bf16 version reads above the bf16 mean limit (so a bf16 path that
    computes fp32 fails it), while the bf16 conv reads below it."""
    G, C, K, Ns, Nd, Fs, Fd = 4, 96, 16, 90, 37, 104, 107
    conv, rng = _random_conv(7, Fs, Fd, G, C)
    t = lambda a: torch.from_numpy(a)  # noqa: E731
    xs = t(rng.uniform(0, 1, (Ns, Fs)).astype(np.float32))
    xd = t(rng.uniform(0, 1, (Nd, Fd)).astype(np.float32))
    nbr = t(rng.integers(0, Ns, (Nd, K)).astype(np.int32))
    ln = t(rng.uniform(0, 0.3, (Nd, K)).astype(np.float32))
    mask = t(_scattered_mask(rng, Nd, K))
    ref = period_conv.apply_period_conv_plain(
        conv, xs, xd, nbr, ln, mask, num_gates=G, out_channels=C,
        precision="bf16")
    outs = {p: edge_stage.launch(
                emulated(src, edge_stage.ENTRIES[p][1]["conv"],
                         edge_stage.ARGTYPES[p]["conv"]), 0,
                conv, xs, xd, nbr, ln, mask, G, C, p)
            for p, src in (("fp32", edge_stage.SOURCE),
                           ("bf16", edge_stage.SOURCE_BF16))}
    _bf16_close(outs["bf16"], ref)
    err = (outs["fp32"] - ref).abs()
    assert float(err.mean()) > 10 * BF16_MEAN * float(ref.abs().max())


@pytest.mark.parametrize("K,C", [(65, 8), (3, 129)])
def test_edge_stage_bf16_source_refuses_what_it_cannot_take(emulated, K, C):
    """Rings past 64 slots and gates past 128 columns: the bf16 entries
    refuse them, as the fp32 ones do (no fallback)."""
    G, N, F = 1, 5, 8
    conv, rng = _random_conv(0, F, F, G, C)
    x = torch.from_numpy(rng.uniform(0, 1, (N, F)).astype(np.float32))
    nbr = torch.zeros((N, K), dtype=torch.int32)
    f = torch.ones((N, K))
    proj = period_conv.node_projections_plain(conv, x, x, "bf16")
    raw = {w: e.raw for w, e in _bf16_entries(emulated).items()}
    for which, call in (
            ("edge_attn", lambda fn: edge_stage.launch_edge_attn(
                fn, 0, conv, x, x, nbr, f, f, proj, G, C, "bf16")),
            ("conv", lambda fn: edge_stage.launch(fn, 0, conv, x, x, nbr, f,
                                                  f, G, C, "bf16"))):
        codes = []
        call(lambda *a: codes.append(raw[which](*a)))
        assert codes[0] != 0, which


def test_node_proj_bf16_source_refuses_unaligned_rows(emulated):
    """The bulk copies take 16-byte aligned sources: an x_src 4 bytes off
    its allocation is refused by the wrapper's check and by the C entry
    (no fallback), and the same values aligned go through."""
    G, C, N, F = 1, 8, 9, 11
    conv, rng = _random_conv(1, F, F, G, C)
    buf = torch.from_numpy(rng.uniform(0, 1, N * F + 1).astype(np.float32))
    x = buf[1:].view(N, F)
    assert x.data_ptr() % 16 == 4
    with pytest.raises(ValueError, match="16-byte aligned"):
        edge_stage._aligned("bf16", conv, x, x)
    fn = _bf16_entries(emulated)["node_proj"]
    codes = []
    edge_stage.launch_node_proj(lambda *a: codes.append(fn.raw(*a)), 0, conv,
                                x, x, "bf16")
    assert codes == [716]            # cudaErrorMisalignedAddress
    out = edge_stage.launch_node_proj(fn, 0, conv, x.clone(), x.clone(),
                                      "bf16")
    for o, r in zip(out, period_conv.node_projections_plain(conv, x, x,
                                                            "bf16")):
        torch.testing.assert_close(o, r, atol=1e-5, rtol=1e-5)


def test_phase_trace_finds_its_anchors():
    """scripts/bf16_phase_trace.py times the phases between the
    TRACE_STAMP / TRACE_END markers of the bf16 source: every point it
    reads has its marker (the script raises on a missing one), the copy
    defines the markers before the source's empty defaults, and the
    kernels' own build leaves them empty."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "scripts", "bf16_phase_trace.py")
    spec = importlib.util.spec_from_file_location("bf16_phase_trace", path)
    trace = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(trace)
    src = trace.stamped_source()
    marked = {(int(k), int(i)) for k, i in re.findall(
        r"TRACE_(?:STAMP|END)\((\d+), (\d+)[,)]", src)}
    assert marked == {(k, i) for k, pts in trace.POINTS.items() for i in pts}
    assert src.index("#define TRACE_STAMP(k, i, on) do") < src.index(
        "#ifndef TRACE_STAMP")
    assert "int trace_read(" in src
    with open(os.path.join(_build.CSRC, edge_stage.SOURCE_BF16 + ".cu")) as f:
        own = f.read()
    assert "#define TRACE_STAMP(k, i, on)\n#define TRACE_END(k, i)\n" in own


def _cell_update_inputs(rng, n, C, messages, zero_c, saturated):
    """One part's messages, bias and c; where saturated, a quarter of the
    message entries at +-40, where sigmoid and tanh round to their
    limits."""
    def msg():
        m = rng.normal(0, 2, (n, 4 * C)).astype(np.float32)
        if saturated:
            hit = rng.uniform(size=m.shape) < 0.25
            m[hit] = rng.choice([-40.0, 40.0], size=int(hit.sum()))
        return torch.from_numpy(m)

    bias = torch.from_numpy(rng.normal(0, 0.5, (4, C)).astype(np.float32))
    c = None if zero_c else torch.from_numpy(
        rng.normal(0, 1, (n, C)).astype(np.float32))
    return tuple(msg() for _ in range(messages)), bias, c


def _torch_update(msgs, bias, c, C):
    """The torch formulation of one part (cells._gate_update) in float64.
    (The CPU's float32 sigmoid and tanh have read up to 6e-5 off in the
    first call of a process, and exact in the calls after it.)"""
    return cells._gate_update(tuple(m.double() for m in msgs), bias.double(),
                              None if c is None else c.double(), C)


@pytest.mark.parametrize("C,nj,ng,zero_c,saturated", [
    (96, 1043, 127, False, False), (96, 127, 1043, True, False),
    (32, 1, 0, False, False), (32, 0, 1, True, False),
    (96, 0, 0, False, False), (96, 127, 1, False, True),
    (32, 1043, 1043, True, True)])
def test_cell_update_source_matches_torch(emulated, C, nj, ng, zero_c,
                                          saturated):
    """csrc/cell_update.cu against the torch formulation it replaces
    (cells._gate_update, in float64), within 1e-6: the joints' two
    messages and the grains' one in one launch, at 0, 1, 127 and 1043 rows,
    c given or null (the zero state), and logits saturated at +-40."""
    fn = emulated(cell_update.SOURCE, "cell_update_forward",
                  cell_update.ARGTYPES)
    rng = np.random.default_rng(C + nj + 7 * ng)
    joint = _cell_update_inputs(rng, nj, C, 2, zero_c, saturated)
    grain = _cell_update_inputs(rng, ng, C, 1, zero_c, saturated)
    outs = cell_update.launch(fn, 0, joint, grain, C)
    for part, out in zip((joint, grain), outs):
        for got, want in zip(out, _torch_update(*part, C)):
            assert got.shape == want.shape and got.dtype == torch.float32
            torch.testing.assert_close(got.double(), want, atol=1e-6, rtol=0)


def test_cell_update_source_refuses_what_it_cannot_take(emulated):
    """C not a multiple of 4, or a row not 16-byte aligned, is refused
    before any launch: the wrapper raises, and the C entry returns an
    error code."""
    fn = emulated(cell_update.SOURCE, "cell_update_forward",
                  cell_update.ARGTYPES)
    rng = np.random.default_rng(0)
    part = _cell_update_inputs(rng, 5, 6, 1, True, False)
    with pytest.raises(ValueError, match="multiple of 4"):
        cell_update.launch(fn, 0, part, part, 6)
    msgs, bias, _ = _cell_update_inputs(rng, 5, 8, 1, True, False)
    offset = torch.zeros(5 * 32 + 1)[1:].view(5, 32)
    offset.copy_(msgs[0])
    with pytest.raises(ValueError, match="16-byte"):
        cell_update.launch(fn, 0, ((offset,), bias, None),
                           (msgs, bias, None), 8)
    out = torch.empty(5, 8)

    def args(msg):
        return [msg.data_ptr(), 0, bias.data_ptr(), 0, 5, out.data_ptr(),
                out.data_ptr()] * 2

    assert fn.raw(*args(msgs[0]), 8, None) == 0
    assert fn.raw(*args(msgs[0]), 6, None) != 0
    assert fn.raw(*args(offset), 8, None) != 0


@functools.lru_cache(maxsize=1)
def _editor_cases():
    """{scenario: [(state, logits, grain_events, y_grain)]} on the 120 um
    fixture graph."""
    x, edges, mask, lxd, patch = dd.load_fixture()
    st, _, _ = dd.init_scaled_state(x, edges, mask, lxd, patch, device="cpu")
    slack, _, _ = dd.init_scaled_state(x, edges, mask, lxd, patch,
                                       nucleation_slack=256, device="cpu")
    rng = np.random.default_rng(0)
    NJ = st.xj.shape[0]
    ts = tj.TopoState(
        E_pp=st.E_pp, E_pq=st.E_pq, xj=st.xj,
        y_joint=torch.from_numpy(
            rng.uniform(-0.9, 0.9, (NJ, 2)).astype(np.float32)),
        mask_g=st.mask_g, mask_j=st.mask_j, append_ptr=st.n_pp)
    return {
        "forced": [chip_smoke.forced_editor_inputs(ts, s, n_sw, n_el)
                   for s, n_sw, n_el in ((0, 8, 2), (1, 24, 4), (2, 30, 0))],
        "clustered": [chip_smoke.clustered_switch_inputs(ts)],
        "forced_out": chip_smoke.forced_out_chain(ts),
        "windowed": [chip_smoke.windowed_editor_inputs(slack, s, n_sw, n_el)
                     for s, n_sw, n_el in ((3, 24, 8), (4, 12, 4))],
    }


@pytest.mark.parametrize("scenario", ["forced", "clustered", "forced_out",
                                      "windowed"])
@pytest.mark.parametrize("threads", [64, 96])
def test_editor_source_matches_plain(emulated, threads, scenario):
    """Threads per block are a compile-time constant; 64 and 96 give two
    and three warps and uneven scan chunks (the card uses more). Scenarios:
    forced switches and eliminations, switches clustered on a few grains'
    rings (the lookahead decides how each reconnects), an edit chain that
    ends in a forced elimination, and a state with nucleation slack and
    nucleated grains under melt pool windows open where x < 0.5."""
    fn = emulated(editor_fused.SOURCE, "editor_update",
                  editor_fused._ARGTYPES, (f"EDITOR_THREADS={threads}",))
    cases = _editor_cases()[scenario]
    assert cases
    n_extra = n_gated = 0
    for ts, logits, ge, yg, *active_g in cases:
        active_g = (active_g or [None])[0]
        prob = torch.sigmoid(logits)
        NG = ts.mask_g.shape[0]
        ref = editor_fused.update_from_prob(ts, prob, ge, yg, 0.6, NG,
                                            active_g=active_g)
        out = editor_fused.launch(fn, 0, ts, prob, ge, yg, 0.6, NG,
                                  tj.MAX_SWITCH, active_g)
        if active_g is not None:
            open_ = editor_fused.update_from_prob(
                dataclasses.replace(ts, active_j=None), prob, ge, yg, 0.6, NG)
            n_gated += not (torch.equal(open_[0].mask_g, ref[0].mask_g)
                            and torch.equal(open_[1], ref[1]))
        for f in ("E_pp", "E_pq", "mask_g", "mask_j", "append_ptr"):
            assert torch.equal(getattr(out[0], f), getattr(ref[0], f)), f
        assert torch.equal(out[1], ref[1]) and torch.equal(out[2], ref[2])
        for f in ("xj", "y_joint"):
            torch.testing.assert_close(getattr(out[0], f),
                                       getattr(ref[0], f), atol=1e-6, rtol=0)
        n_extra += int((ref[2] >= 0).sum())
    if scenario == "forced_out":
        assert n_extra >= 1        # the forced elimination ran
    if scenario == "windowed":
        assert n_gated == len(cases)   # the windows changed every edit


@pytest.mark.parametrize("threads", [64, 96])
def test_editor_source_cleanup_mask_matches_plain(emulated, threads):
    """The cleanup mask cg: on the 120 um graph with three grains made
    two-sided before the edit, the source with a mask that spares one of
    them matches the plain version with that mask, and the spared grain
    lives; a null mask gives the bits of a mask of all ones."""
    fn = emulated(editor_fused.SOURCE, "editor_update",
                  editor_fused._ARGTYPES, (f"EDITOR_THREADS={threads}",))
    ts0 = _editor_cases()["forced"][0][0]
    NG = ts0.mask_g.shape[0]
    for seed in (0, 1):
        ts, logits, ge, yg, cg = chip_smoke.two_sided_inputs(ts0, seed)
        prob = torch.sigmoid(logits)
        ref = editor_fused.update_from_prob(ts, prob, ge, yg, 0.6, NG,
                                            cleanup_g_mask=cg)
        out = editor_fused.launch(fn, 0, ts, prob, ge, yg, 0.6, NG,
                                  tj.MAX_SWITCH, cleanup_g_mask=cg)
        for f in ("E_pp", "E_pq", "mask_g", "mask_j", "append_ptr"):
            assert torch.equal(getattr(out[0], f), getattr(ref[0], f)), f
        assert torch.equal(out[1], ref[1]) and torch.equal(out[2], ref[2])
        torch.testing.assert_close(out[0].xj, ref[0].xj, atol=1e-6, rtol=0)
        null = editor_fused.launch(fn, 0, ts, prob, ge, yg, 0.6, NG,
                                   tj.MAX_SWITCH)
        ones = editor_fused.launch(fn, 0, ts, prob, ge, yg, 0.6, NG,
                                   tj.MAX_SWITCH,
                                   cleanup_g_mask=torch.ones_like(cg))
        for a, b in zip((null[0].E_pp, null[0].E_pq, null[0].mask_g,
                         null[0].xj, null[1], null[2]),
                        (ones[0].E_pp, ones[0].E_pq, ones[0].mask_g,
                         ones[0].xj, ones[1], ones[2])):
            assert torch.equal(a, b)
        spared = int(torch.nonzero(~cg)[0])
        assert int(null[0].mask_g[spared]) == 0
        assert int(out[0].mask_g[spared]) == 1


def test_editor_candidates_beyond_max_switch(emulated):
    """More candidates over the threshold than max_switch, with tied
    probabilities: the rank selection keeps the first max_switch in
    (-p, column) order."""
    fn = emulated(editor_fused.SOURCE, "editor_update",
                  editor_fused._ARGTYPES, ("EDITOR_THREADS=64",))
    ts = _editor_cases()["forced"][0][0]
    E = ts.E_pp
    rng = np.random.default_rng(3)
    logits = torch.full((E.shape[1],), -50.0)
    cand = torch.nonzero((E[0] < E[1]) & (E[0] >= 0)).flatten()
    pick = cand[torch.from_numpy(rng.choice(len(cand), 90, replace=False))]
    logits[pick] = torch.from_numpy(
        rng.choice([6.0, 7.0, 9.0], 90).astype(np.float32))
    prob = torch.sigmoid(logits)
    NG = ts.mask_g.shape[0]
    ge = torch.full((tj.MAX_ELIM,), -1, dtype=torch.int32)
    yg = torch.zeros((NG, 2))
    ref = editor_fused.update_from_prob(ts, prob, ge, yg, 0.6, NG)
    out = editor_fused.launch(fn, 0, ts, prob, ge, yg, 0.6, NG, tj.MAX_SWITCH)
    assert torch.equal(out[1], ref[1])
    assert torch.equal(out[0].E_pp, ref[0].E_pp)
    assert int((ref[1][:, 0] >= 0).sum()) > 0


def test_editor_source_over_lanes_matches_plain(emulated):
    """One launch of the editor over 3 lanes of different sizes and
    contents (forced switches and eliminations on the 120 um graph; a
    nucleated state with slack under melt pool windows; many switches and
    no elimination): each lane bit-equal to the plain editor and to a
    launch of that lane alone."""
    fn = emulated(editor_fused.SOURCE, "editor_update",
                  editor_fused._ARGTYPES, ("EDITOR_THREADS=64",))
    cases = _editor_cases()
    forced = cases["forced"]
    lanes = [forced[0], cases["windowed"][0], forced[2]]
    ts, logits, ge, yg, ag = chip_smoke.stack_editor_lanes(lanes)
    assert len({c[0].mask_j.shape[0] for c in lanes}) == 2
    prob = torch.sigmoid(logits)
    NG = ts.mask_g.shape[1]
    ref = editor_fused.update_from_prob(ts, prob, ge, yg, 0.6, NG,
                                        active_g=ag)
    out = editor_fused.launch(fn, 0, ts, prob, ge, yg, 0.6, NG,
                              tj.MAX_SWITCH, ag)
    for b in range(len(lanes)):
        one = editor_fused.launch(
            fn, 0, ts.map(lambda v: v[b]), prob[b], ge[b], yg[b], 0.6, NG,
            tj.MAX_SWITCH, ag[b])
        for f in ("E_pp", "E_pq", "mask_g", "mask_j", "append_ptr", "xj",
                  "y_joint"):
            assert torch.equal(getattr(out[0], f)[b], getattr(ref[0], f)[b]), f
            assert torch.equal(getattr(one[0], f), getattr(ref[0], f)[b]), f
        for k in (1, 2):
            assert torch.equal(out[k][b], ref[k][b])
            assert torch.equal(one[k], ref[k][b])
        assert int((ref[1][b, :, 0] >= 0).sum()) > 0
    assert int((ref[0].mask_g != ts.mask_g).sum()) > 0


def test_editor_refuses_budgets_past_its_limits(emulated):
    """Per-lane budgets past MAX_MS switches or MAX_GE grain events (a
    packed state of 8 lanes needs 192 and 64): the wrapper raises before
    building anything, and the C entry refuses them."""
    ts, logits, ge, yg = _editor_cases()["forced"][0]
    prob = torch.sigmoid(logits)
    NG = ts.mask_g.shape[0]
    with pytest.raises(ValueError, match="at most 64 switches"):
        editor_fused._update_cuda(ts, prob, ge, yg, 0.6, NG,
                                  tj.MAX_SWITCH * 8, None)
    ge64 = torch.full((tj.MAX_ELIM * 8,), -1, dtype=torch.int32)
    with pytest.raises(ValueError, match="16 grain events"):
        editor_fused._update_cuda(ts, prob, ge64, yg, 0.6, NG,
                                  tj.MAX_SWITCH, None)
    fn = emulated(editor_fused.SOURCE, "editor_update",
                  editor_fused._ARGTYPES, ("EDITOR_THREADS=64",))
    codes = []
    for ms, g in ((editor_fused.MAX_MS + 1, ge), (tj.MAX_SWITCH, ge64)):
        editor_fused.launch(lambda *a: codes.append(fn.raw(*a)), 0, ts, prob,
                            g, yg, 0.6, NG, ms)
    assert all(c != 0 for c in codes)
