// The PGCLSTM cell step's update, both node types in one launch, for Hopper.
//
// Per node row of a part (the joints, then the grains), with the messages
// of the cell step's convs in gate order (i, f, c~, o), each [N, 4C] fp32:
//
//   x  = (a + b) + bias          (joints: a = push, b = connect)
//   x  = a + bias                (grains: a = pull, no b)
//   i, f, o = sigmoid(x_i, x_f, x_o)     g = tanh(x_c~)
//   c' = f c + i g               h' = o tanh(c')
//
// written as contiguous [N, C] fp32 h' and c'. A null c is the zero state
// (the encoder's): nothing is read for it, and c' = f 0 + i g.
//
// The arithmetic is the torch formulation's (models/cells.py: the gate
// sums, then _lstm_update), one rounding a torch operation: sigmoid as
// 1 / (1 + expf(-x)) and tanhf, as ATen's CUDA kernels compute them, the
// sums in the same order, and the products and sums of c' and h' rounded
// apart (__fmul_rn / __fadd_rn, which nvcc does not contract into an FMA).
// No fast-math flag, so expf, tanhf and the division are the accurate
// ones; the card's result equals the torch formulation's on the card.
//
// Bound: bytes. Each message row, c and the bias are read once and h' and
// c' written once; there are 4-8 flops a byte to spare. A thread owns a
// (row, 4 channels) group: four aligned float4 loads a message (one per
// gate block) and one of c, all issued before any arithmetic, then two
// float4 stores. The threads of a row are consecutive, so each load
// instruction of a warp reads whole 128-byte lines of one gate block.
// The joints' blocks come first in the grid, so no warp holds rows of both
// parts.

#include <cuda_runtime.h>

namespace {

constexpr int CU_THREADS = 256;

struct Part {
  const float* a;      // [n, 4C]
  const float* b;      // [n, 4C] or null
  const float* bias;   // [4C]
  const float* c;      // [n, C] or null (zeros)
  float* h_out;        // [n, C]
  float* c_out;        // [n, C]
  int n;
  int blocks;          // this part's blocks of the grid
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// c' = f c + i g and h' = o tanh(c') of one channel, from its gate inputs
__device__ __forceinline__ void lstm(float xi, float xf, float xg, float xo,
                                     float c, float& h_new, float& c_new) {
  const float i = sigmoid(xi), f = sigmoid(xf), g = tanhf(xg),
              o = sigmoid(xo);
  c_new = __fadd_rn(__fmul_rn(f, c), __fmul_rn(i, g));
  h_new = __fmul_rn(o, tanhf(c_new));
}

__global__ void __launch_bounds__(CU_THREADS)
cell_update_kernel(Part joint, Part grain, int C) {
  const bool is_joint = blockIdx.x < (unsigned)joint.blocks;
  const Part p = is_joint ? joint : grain;
  const unsigned block = is_joint ? blockIdx.x : blockIdx.x - joint.blocks;
  const unsigned groups = (unsigned)C / 4u;      // float4 groups a row
  const unsigned t = block * CU_THREADS + threadIdx.x;
  if (t >= (unsigned)p.n * groups) return;
  const unsigned row = t / groups, col = 4u * (t - row * groups);
  const size_t msg = (size_t)row * 4u * C + col, st = (size_t)row * C + col;
  float4 x[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) x[k] = load4(p.a + msg + (size_t)k * C);
  float4 y[4];
  if (p.b != nullptr) {
#pragma unroll
    for (int k = 0; k < 4; ++k) y[k] = load4(p.b + msg + (size_t)k * C);
  }
  const float4 c = p.c != nullptr ? load4(p.c + st) : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float4 bk = load4(p.bias + (size_t)k * C + col);
    if (p.b != nullptr) {
      x[k].x = __fadd_rn(x[k].x, y[k].x);
      x[k].y = __fadd_rn(x[k].y, y[k].y);
      x[k].z = __fadd_rn(x[k].z, y[k].z);
      x[k].w = __fadd_rn(x[k].w, y[k].w);
    }
    x[k].x = __fadd_rn(x[k].x, bk.x);
    x[k].y = __fadd_rn(x[k].y, bk.y);
    x[k].z = __fadd_rn(x[k].z, bk.z);
    x[k].w = __fadd_rn(x[k].w, bk.w);
  }
  float4 h, cn;
  lstm(x[0].x, x[1].x, x[2].x, x[3].x, c.x, h.x, cn.x);
  lstm(x[0].y, x[1].y, x[2].y, x[3].y, c.y, h.y, cn.y);
  lstm(x[0].z, x[1].z, x[2].z, x[3].z, c.z, h.z, cn.z);
  lstm(x[0].w, x[1].w, x[2].w, x[3].w, c.w, h.w, cn.w);
  *reinterpret_cast<float4*>(p.h_out + st) = h;
  *reinterpret_cast<float4*>(p.c_out + st) = cn;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<size_t>(p) & 15u) == 0;
}

Part make_part(const float* a, const float* b, const float* bias,
               const float* c, int n, float* h_out, float* c_out, int C) {
  const long long threads = (long long)n * (C / 4);
  return Part{a, b, bias, c, h_out, c_out, n,
              (int)((threads + CU_THREADS - 1) / CU_THREADS)};
}

}  // namespace

extern "C" {

const char* ggnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One cell step's update of the joints (messages ja and jb, bias jbias,
// state jc) and the grains (ga, gb, gbias, gc), one launch. b and c may
// be null; a part of n = 0 rows takes no block. C a multiple of 4, every
// pointer 16-byte aligned, n * C / 4 below 2^31.
int cell_update_forward(const float* ja, const float* jb, const float* jbias,
                        const float* jc, int nj, float* jh_out,
                        float* jc_out, const float* ga, const float* gb,
                        const float* gbias, const float* gc, int ng,
                        float* gh_out, float* gc_out, int C,
                        cudaStream_t stream) {
  if (C <= 0 || C % 4 != 0 || nj < 0 || ng < 0
      || (long long)nj * (C / 4) >= (1ll << 31)
      || (long long)ng * (C / 4) >= (1ll << 31))
    return cudaErrorInvalidValue;
  const void* ptrs[] = {ja, jb, jbias, jc, jh_out, jc_out,
                        ga, gb, gbias, gc, gh_out, gc_out};
  for (const void* q : ptrs)
    if (!aligned16(q)) return cudaErrorMisalignedAddress;
  const Part joint = make_part(ja, jb, jbias, jc, nj, jh_out, jc_out, C);
  const Part grain = make_part(ga, gb, gbias, gc, ng, gh_out, gc_out, C);
  const int blocks = joint.blocks + grain.blocks;
  if (blocks == 0) return cudaSuccess;
  cell_update_kernel<<<blocks, CU_THREADS, 0, stream>>>(joint, grain, C);
  return cudaGetLastError();
}

}  // extern "C"
