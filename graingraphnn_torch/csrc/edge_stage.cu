// Fused periodic graph-transformer conv (PeriodConv), fp32, for Hopper.
//
// Replaces the TPU kernels graingraphnn_tpu/kernels/edge_stage.py::_kernel
// (K < 8: push and connect, K = 3) and ::_kernel_flat (K >= 8: pull,
// K = RING_MAX = 16), both launched by apply_period_conv_pallas. Per
// destination row i and neighbor slot k (source j = nbr[i, k]):
//
//   x_j'   = [wrap(x_j[:3] - x_i[:3]), x_j[3:]]
//   k_e    = x_j' Wk + bk + len * We          q = x_i Wq + bq
//   alpha  = masked softmax over k of  sum_gate(q * k_e) / sqrt(C)
//   v      = relu(x_j' Wv + bv) . blockdiag(Wl2) + bl2
//   out_i  = sum_k alpha (v + len * We) + x_i Wsk + bsk
//
// Design: the shift decomposition. x_j' Wk = x_j Wk + (shift - x_i[:3]) Wk[:3]
// with shift in {-1, 0, 1}^3, so the F-wide projections run once per NODE
// and the edge kernel (edge_attn) gathers projected rows and adds a rank-3
// correction. Two kernels per conv:
//
// node_proj: the four node projections (K, V over sources, Q, skip over
//   destinations) as ONE grouped launch; the block index picks the product
//   and its 64 x 128 output tile. Bound: bytes (the [N, 2 GC] outputs) at
//   the tensor cores' rate. The tile's x rows and W columns over the whole
//   depth (F zero-padded to a multiple of 8) come into shared memory by
//   cp.async, with row strides that make every fragment load
//   conflict-free; 4 warps each take a 32 x 64 sub-tile on mma.sync
//   m16n8k8 in 3xTF32 (csrc/mma_tf32.cuh): each operand is split into
//   hi + lo TF32 parts at the fragment load, and lo*hi + hi*lo + hi*hi go
//   into fp32 accumulators, which keeps near-fp32 error. The tile goes out
//   through shared memory in rows of 16-byte stores. ~101 KB of shared
//   memory per block leaves two blocks per SM, whose loads and products
//   overlap.
//
// edge_attn: one block per tile of destination rows, one thread per output
//   column; the per-gate logit sums and the softmax over K go through
//   shared memory in a fixed order; the block-diagonal l2 product keeps one
//   accumulator per edge of the tile in registers and reads each Wl2
//   element once per tile. Masked slots are skipped in the l2 product
//   (their alpha is exactly 0). Bound: operations (2 * G*C * C per live
//   edge for l2); the inner loops are bound by shared-memory reads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr int MAX_F = 128;      // node feature width the kernels take
constexpr int MAX_GC = 512;     // G * C output columns
constexpr int MAX_G = 8;
constexpr int MAX_K = 16;       // neighbor slots per row
constexpr int EDGES = 16;       // edge slots per edge_attn block
constexpr float NEG = -1e30f;

// node_proj tiling
constexpr int NP_BM = 64;                 // rows of a block tile
constexpr int NP_BN = 128;                // columns of a block tile
constexpr int NP_THREADS = 128;           // 4 warps in 2 x 2, each a quarter tile
constexpr int NP_MI = NP_BM / 2 / 16;     // m16 products per warp
constexpr int NP_NI = NP_BN / 2 / 8;      // n8 products per warp
constexpr int NP_XS = MAX_F + 4;          // x row stride: fragment rows 4 banks apart
constexpr int NP_WS = NP_BN + 8;          // W row stride: fragment k rows 8 banks apart
constexpr int NP_SMEM = (NP_BM * NP_XS + MAX_F * NP_WS) * (int)sizeof(float);
constexpr int NP_BLOCKS = 232448 / (NP_SMEM + 1024);   // blocks an SM holds
static_assert(NP_BN <= NP_XS && NP_BLOCKS >= 1, "node_proj tiles");

// A build with -DNODE_PROJ_PART=1 leaves out node_proj's products, and one
// with 2 its device-memory loads and stores; they exist to time the parts
// (scripts/torch_kernel_probe.py) and compute nothing of use.
#ifndef NODE_PROJ_PART
#define NODE_PROJ_PART 0
#endif
constexpr bool NP_PRODUCTS = NODE_PROJ_PART != 1;
constexpr bool NP_MEMORY = NODE_PROJ_PART != 2;

struct Proj {                             // y [N, GC] = x [N, F] w [F, GC] + b
  const float* x; const float* w; const float* b; float* y; int N, F;
};
struct ProjSet {
  Proj p[4];
  int tiles[4];                           // block tiles of each product
  int GC;
};

// One NP_BM x NP_BN tile of one of the grouped products, in 3xTF32.
__global__ void __launch_bounds__(NP_THREADS, NP_BLOCKS) node_proj(ProjSet P) {
  extern __shared__ __align__(16) float np_smem[];
  float* xs = np_smem;                    // [NP_BM][NP_XS]
  float* ws = np_smem + NP_BM * NP_XS;    // [MAX_F][NP_WS]
  int t = blockIdx.x, pi = 0;
  while (pi < 3 && t >= P.tiles[pi]) t -= P.tiles[pi++];
  const Proj pr = P.p[pi];
  const int GC = P.GC, F = pr.F, Fp = (F + 7) & ~7;
  const int ncol = (GC + NP_BN - 1) / NP_BN;
  const int row0 = (t / ncol) * NP_BM, col0 = (t % ncol) * NP_BN;
  const int nrows = min(NP_BM, pr.N - row0), ncols = min(NP_BN, GC - col0);

  // x rows [row0, row0 + NP_BM) and W columns [col0, col0 + NP_BN) over the
  // depth Fp, zero-padded; 16-byte copies where the rows allow them
  const bool xvec = F % 4 == 0 && (reinterpret_cast<uintptr_t>(pr.x) & 15) == 0;
  const bool wvec = GC % 4 == 0 && (reinterpret_cast<uintptr_t>(pr.w) & 15) == 0;
  for (int i = threadIdx.x; i < NP_BM * (Fp / 4); i += NP_THREADS) {
    const int r = i / (Fp / 4), f = (i % (Fp / 4)) * 4;
    float* dst = xs + r * NP_XS + f;
    const float* src = pr.x + (size_t)(row0 + r) * F + f;
    if (NP_MEMORY && xvec && r < nrows && f < F) {
      cp_async16(dst, src);
    } else {
      for (int u = 0; u < 4; ++u) {
        if (NP_MEMORY && r < nrows && f + u < F) cp_async4(dst + u, src + u);
        else dst[u] = 0.f;
      }
    }
  }
  for (int i = threadIdx.x; i < Fp * (NP_BN / 4); i += NP_THREADS) {
    const int f = i / (NP_BN / 4), c = (i % (NP_BN / 4)) * 4;
    float* dst = ws + f * NP_WS + c;
    const float* src = pr.w + (size_t)f * GC + col0 + c;
    if (NP_MEMORY && wvec && f < F && c + 4 <= ncols) {
      cp_async16(dst, src);
    } else {
      for (int u = 0; u < 4; ++u) {
        if (NP_MEMORY && f < F && c + u < ncols) cp_async4(dst + u, src + u);
        else dst[u] = 0.f;
      }
    }
  }
  cp_async_wait_all();
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int wr = (warp >> 1) * (NP_BM / 2), wc = (warp & 1) * (NP_BN / 2);
  const bool idle = wr >= nrows || wc >= ncols;   // sub-tile all padding
  float acc[NP_MI][NP_NI][4];
#pragma unroll
  for (int mi = 0; mi < NP_MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NP_NI; ++ni)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[mi][ni][u] = 0.f;

  for (int k0 = 0; NP_PRODUCTS && k0 < Fp && !idle; k0 += 8) {
    uint32_t ah[NP_MI][4], al[NP_MI][4];
#pragma unroll
    for (int mi = 0; mi < NP_MI; ++mi) {
      const float* xa = xs + (wr + mi * 16 + g) * NP_XS + k0 + tq;
      split_tf32(xa[0], ah[mi][0], al[mi][0]);
      split_tf32(xa[8 * NP_XS], ah[mi][1], al[mi][1]);
      split_tf32(xa[4], ah[mi][2], al[mi][2]);
      split_tf32(xa[8 * NP_XS + 4], ah[mi][3], al[mi][3]);
    }
#pragma unroll
    for (int ni = 0; ni < NP_NI; ++ni) {
      const float* wb = ws + (k0 + tq) * NP_WS + wc + ni * 8 + g;
      uint32_t bh[2], bl[2];
      split_tf32(wb[0], bh[0], bl[0]);
      split_tf32(wb[4 * NP_WS], bh[1], bl[1]);
#pragma unroll
      for (int mi = 0; mi < NP_MI; ++mi) {
        mma_tf32(acc[mi][ni], al[mi], bh);
        mma_tf32(acc[mi][ni], ah[mi], bl);
        mma_tf32(acc[mi][ni], ah[mi], bh);
      }
    }
  }

  // epilogue: the tile through shared memory (in place of x), then its
  // rows out with the bias, 16 bytes a thread where aligned
  __syncthreads();
  float* os = xs;
  if (!idle) {
#pragma unroll
    for (int mi = 0; mi < NP_MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NP_NI; ++ni)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          os[(wr + mi * 16 + g + (u >> 1) * 8) * NP_XS + wc + ni * 8 + 2 * tq + (u & 1)] =
              acc[mi][ni][u];
  }
  __syncthreads();
  const bool yvec = GC % 4 == 0 && ((reinterpret_cast<uintptr_t>(pr.y) |
                                     reinterpret_cast<uintptr_t>(pr.b)) & 15) == 0;
  for (int i = threadIdx.x; i < NP_BM * (NP_BN / 4); i += NP_THREADS) {
    const int r = i / (NP_BN / 4), c = (i % (NP_BN / 4)) * 4;
    if (r >= nrows || c >= ncols) continue;
    if (!NP_MEMORY && acc[0][0][0] != 12345.f) continue;   // keep the products
    const float* o = os + r * NP_XS + c;
    const float* b = pr.b + col0 + c;
    float* y = pr.y + (size_t)(row0 + r) * GC + col0 + c;
    if (yvec && c + 4 <= ncols) {
      const float4 bb = *reinterpret_cast<const float4*>(b);
      *reinterpret_cast<float4*>(y) =
          make_float4(o[0] + bb.x, o[1] + bb.y, o[2] + bb.z, o[3] + bb.w);
    } else {
      for (int u = 0; u < 4 && c + u < ncols; ++u) y[u] = o[u] + b[u];
    }
  }
}

// Gather, attention and aggregation for `rows` destination rows per block.
// blockDim.x = GC rounded up to a warp; thread `col` owns output column col.
__global__ void __launch_bounds__(MAX_GC) edge_attn(
    const float* __restrict__ x_src, int Ns, int Fs,
    const float* __restrict__ x_dst, int Nd, int Fd,
    const int* __restrict__ nbr, const float* __restrict__ elen,
    const float* __restrict__ nmask, int K, int rows,
    const float* __restrict__ kn, const float* __restrict__ vn,
    const float* __restrict__ q, const float* __restrict__ sk,
    const float* __restrict__ wk, const float* __restrict__ wv,
    const float* __restrict__ wl2, const float* __restrict__ bl2,
    const float* __restrict__ we, int G, int C, float* __restrict__ out) {
  __shared__ float s_buf[EDGES][MAX_GC];
  __shared__ float s_shift[EDGES][3];
  __shared__ float s_len[EDGES], s_mask[EDGES];
  __shared__ int s_j[EDGES];
  __shared__ float s_alpha[EDGES][MAX_G];

  const int GC = G * C;
  const int row0 = blockIdx.x * rows;
  const int nrows = min(rows, Nd - row0);
  const int ne = nrows * K;
  const int tid = threadIdx.x;

  for (int e = tid; e < EDGES; e += blockDim.x) {
    const int r = e / K, k = e % K;
    float sh[3] = {0.f, 0.f, 0.f};
    int j = 0;
    float len = 0.f, m = 0.f;
    if (e < ne) {
      const int i = row0 + r;
      j = nbr[i * K + k];
      if (j < 0 || j >= Ns) j = 0;
      len = elen[i * K + k];
      m = nmask[i * K + k];
      for (int d = 0; d < 3; ++d) {
        const float rel = x_src[(size_t)j * Fs + d] - x_dst[(size_t)i * Fd + d];
        sh[d] = (rel < -0.5f ? 1.f : 0.f) - (rel > 0.5f ? 1.f : 0.f);
      }
    }
    s_j[e] = j;
    s_len[e] = len;
    s_mask[e] = m;
    for (int d = 0; d < 3; ++d) s_shift[e][d] = sh[d];
  }
  __syncthreads();

  const int col = tid < GC ? tid : GC - 1;   // spare lanes mirror the last column
  const int g = col / C, dcol = col - g * C;
  const float wk0 = wk[col], wk1 = wk[GC + col], wk2 = wk[2 * GC + col];
  const float wv0 = wv[col], wv1 = wv[GC + col], wv2 = wv[2 * GC + col];
  const float we_c = we[col];

  // pass 1: q * k_e per column
  for (int e = 0; e < ne; ++e) {
    const int i = row0 + e / K;
    const float* xi = x_dst + (size_t)i * Fd;
    const float pk = xi[0] * wk0 + xi[1] * wk1 + xi[2] * wk2;
    const float ke = kn[(size_t)s_j[e] * GC + col] - pk
        + (s_shift[e][0] * wk0 + s_shift[e][1] * wk1 + s_shift[e][2] * wk2)
        + s_len[e] * we_c;
    if (tid < GC) s_buf[e][col] = q[(size_t)i * GC + col] * ke;
  }
  __syncthreads();

  // per-gate logits, in place of the gate's first column
  const float inv = 1.f / sqrtf((float)C);
  for (int t = tid; t < ne * G; t += blockDim.x) {
    const int e = t / G, gg = t % G;
    float s = 0.f;
    for (int c = 0; c < C; ++c) s += s_buf[e][gg * C + c];
    s_alpha[e][gg] = s_mask[e] > 0.f ? s * inv : NEG;
  }
  __syncthreads();

  // masked softmax over the K slots of each row and gate
  for (int t = tid; t < nrows * G; t += blockDim.x) {
    const int r = t / G, gg = t % G;
    float lmax = NEG;
    for (int k = 0; k < K; ++k) lmax = fmaxf(lmax, s_alpha[r * K + k][gg]);
    if (lmax <= NEG / 2) lmax = 0.f;
    float denom = 0.f;
    for (int k = 0; k < K; ++k) {
      const int e = r * K + k;
      const float ex = s_mask[e] > 0.f ? expf(s_alpha[e][gg] - lmax) : 0.f;
      s_alpha[e][gg] = ex;
      denom += ex;
    }
    denom = fmaxf(denom, 1e-30f);
    for (int k = 0; k < K; ++k) s_alpha[r * K + k][gg] /= denom;
  }

  // pass 2: relu(pre-value) per column
  for (int e = 0; e < ne; ++e) {
    const int i = row0 + e / K;
    const float* xi = x_dst + (size_t)i * Fd;
    const float pv = xi[0] * wv0 + xi[1] * wv1 + xi[2] * wv2;
    const float pre = vn[(size_t)s_j[e] * GC + col] - pv
        + (s_shift[e][0] * wv0 + s_shift[e][1] * wv1 + s_shift[e][2] * wv2);
    if (tid < GC) s_buf[e][col] = fmaxf(pre, 0.f);
  }
  __syncthreads();

  // block-diagonal l2 product over the live edges of the tile
  float acc[EDGES];
#pragma unroll
  for (int e = 0; e < EDGES; ++e) acc[e] = 0.f;
  const float* w = wl2 + (size_t)g * C * C + dcol;
  const int base = g * C;
  for (int c = 0; c < C; ++c) {
    const float wc = w[(size_t)c * C];
#pragma unroll
    for (int e = 0; e < EDGES; ++e)
      if (e < ne && s_mask[e] > 0.f) acc[e] += s_buf[e][base + c] * wc;
  }
  __syncthreads();

  // messages alpha (v + len We), summed over each row's slots, plus skip
  const float b2 = bl2[col];
#pragma unroll
  for (int e = 0; e < EDGES; ++e)
    if (e < ne && tid < GC)
      s_buf[e][col] = (acc[e] + b2 + s_len[e] * we_c) * s_alpha[e][g];
  if (tid < GC) {
    for (int r = 0; r < nrows; ++r) {
      float o = 0.f;
      for (int k = 0; k < K; ++k) o += s_buf[r * K + k][col];
      const int i = row0 + r;
      out[(size_t)i * GC + col] = o + sk[(size_t)i * GC + col];
    }
  }
}

int launch_node_proj(const float* x_src, int Ns, int Fs, const float* x_dst,
                     int Nd, int Fd, const float* wq, const float* bq,
                     const float* wk, const float* bk, const float* wv,
                     const float* bv, const float* wsk, const float* bsk,
                     int GC, float* kn, float* vn, float* q, float* sk,
                     cudaStream_t s) {
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        node_proj, cudaFuncAttributeMaxDynamicSharedMemorySize, NP_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  ProjSet P{{{x_src, wk, bk, kn, Ns, Fs}, {x_src, wv, bv, vn, Ns, Fs},
             {x_dst, wq, bq, q, Nd, Fd}, {x_dst, wsk, bsk, sk, Nd, Fd}},
            {0, 0, 0, 0}, GC};
  const int ncol = (GC + NP_BN - 1) / NP_BN;
  int total = 0;
  for (int i = 0; i < 4; ++i) {
    P.tiles[i] = (P.p[i].N + NP_BM - 1) / NP_BM * ncol;
    total += P.tiles[i];
  }
  if (total > 0) node_proj<<<total, NP_THREADS, NP_SMEM, s>>>(P);
  return 0;
}

void launch_edge_attn(const float* x_src, int Ns, int Fs, const float* x_dst,
                      int Nd, int Fd, const int* nbr, const float* elen,
                      const float* nmask, int K, const float* kn,
                      const float* vn, const float* q, const float* sk,
                      const float* wk, const float* wv, const float* wl2,
                      const float* bl2, const float* we, int G, int C,
                      float* out, cudaStream_t s) {
  if (Nd <= 0) return;
  const int rows = EDGES / K;
  const int threads = (G * C + 31) / 32 * 32;
  edge_attn<<<(Nd + rows - 1) / rows, threads, 0, s>>>(
      x_src, Ns, Fs, x_dst, Nd, Fd, nbr, elen, nmask, K, rows, kn, vn, q, sk,
      wk, wv, wl2, bl2, we, G, C, out);
}

bool takes(int Fs, int Fd, int G, int C, int K) {
  return Fs <= MAX_F && Fd <= MAX_F && Fs >= 3 && Fd >= 3 &&
         G * C <= MAX_GC && G <= MAX_G && K >= 1 && K <= MAX_K;
}

}  // namespace

extern "C" {

const char* ggnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Fused conv forward: node_proj then edge_attn, two launches. kn/vn
// [Ns, GC] and q/sk [Nd, GC] are scratch the caller allocates; out
// [Nd, GC]. Weights in the JAX package's layout: w [F, GC], b [GC],
// wl2 [G, C, C], bl2 [G, C], we [GC].
int edge_stage_forward(
    const float* x_src, int Ns, int Fs, const float* x_dst, int Nd, int Fd,
    const int* nbr, const float* elen, const float* nmask, int K,
    const float* wq, const float* bq, const float* wk, const float* bk,
    const float* wv, const float* bv, const float* wsk, const float* bsk,
    const float* wl2, const float* bl2, const float* we, int G, int C,
    float* kn, float* vn, float* q, float* sk, float* out, void* stream) {
  if (!takes(Fs, Fd, G, C, K)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();   // clear any stale error
  const int err = launch_node_proj(x_src, Ns, Fs, x_dst, Nd, Fd, wq, bq, wk,
                                   bk, wv, bv, wsk, bsk, G * C, kn, vn, q, sk, s);
  if (err) return err;
  launch_edge_attn(x_src, Ns, Fs, x_dst, Nd, Fd, nbr, elen, nmask, K, kn, vn,
                   q, sk, wk, wv, wl2, bl2, we, G, C, out, s);
  return static_cast<int>(cudaGetLastError());
}

// The node projections alone (one node_proj launch): kn = x_src wk + bk,
// vn = x_src wv + bv, q = x_dst wq + bq, sk = x_dst wsk + bsk.
int edge_node_proj(
    const float* x_src, int Ns, int Fs, const float* x_dst, int Nd, int Fd,
    const float* wq, const float* bq, const float* wk, const float* bk,
    const float* wv, const float* bv, const float* wsk, const float* bsk,
    int GC, float* kn, float* vn, float* q, float* sk, void* stream) {
  if (!takes(Fs, Fd, 1, GC, 1)) return cudaErrorInvalidValue;
  cudaGetLastError();
  const int err = launch_node_proj(x_src, Ns, Fs, x_dst, Nd, Fd, wq, bq, wk,
                                   bk, wv, bv, wsk, bsk, GC, kn, vn, q, sk,
                                   static_cast<cudaStream_t>(stream));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

// The edge kernel alone (one edge_attn launch) on given projections.
int edge_attn_forward(
    const float* x_src, int Ns, int Fs, const float* x_dst, int Nd, int Fd,
    const int* nbr, const float* elen, const float* nmask, int K,
    const float* kn, const float* vn, const float* q, const float* sk,
    const float* wk, const float* wv, const float* wl2, const float* bl2,
    const float* we, int G, int C, float* out, void* stream) {
  if (!takes(Fs, Fd, G, C, K)) return cudaErrorInvalidValue;
  cudaGetLastError();
  launch_edge_attn(x_src, Ns, Fs, x_dst, Nd, Fd, nbr, elen, nmask, K, kn, vn,
                   q, sk, wk, wv, wl2, bl2, we, G, C, out,
                   static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
