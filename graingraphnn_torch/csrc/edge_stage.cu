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
// (node_proj2: K, V over sources, Q, skip over destinations) and the edge
// kernel (edge_attn) gathers projected rows and adds a rank-3 correction.
// One block per tile of destination rows, one thread per output column;
// the per-gate logit sums and the softmax over K go through shared memory
// in a fixed order; the block-diagonal l2 product keeps one accumulator per
// edge of the tile in registers and reads each Wl2 element once per tile.
// Masked slots are skipped in the l2 product (their alpha is exactly 0).
//
// Bound on this card: operations. In fp32 without tensor cores the l2
// product (2 * G*C * C per live edge) and the node projections
// (2 * F * G*C per node and projection) dominate; the bytes moved (node
// features, ELL tables, weights, output) are a few MB per call. The
// design removes the per-edge F-wide projections the TPU kernel recomputes
// (about 7x fewer operations at these widths); the inner loops are bound by
// shared-memory reads, which a later tensor-core version removes.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_F = 128;      // node feature width the kernels take
constexpr int MAX_GC = 512;     // G * C output columns
constexpr int MAX_G = 8;
constexpr int MAX_K = 16;       // neighbor slots per row
constexpr int EDGES = 16;       // edge slots per edge_attn block
constexpr int PROJ_ROWS = 16;   // node rows per node_proj2 block
constexpr int PROJ_THREADS = 128;
constexpr float NEG = -1e30f;

// y1 = x W1 + b1 and y2 = x W2 + b2 for one tile of rows; W [F, GC].
__global__ void __launch_bounds__(PROJ_THREADS) node_proj2(
    const float* __restrict__ x, int N, int F,
    const float* __restrict__ w1, const float* __restrict__ b1,
    const float* __restrict__ w2, const float* __restrict__ b2, int GC,
    float* __restrict__ y1, float* __restrict__ y2) {
  __shared__ float xs[PROJ_ROWS][MAX_F];
  const int row0 = blockIdx.x * PROJ_ROWS;
  const int nrows = min(PROJ_ROWS, N - row0);
  for (int t = threadIdx.x; t < PROJ_ROWS * F; t += blockDim.x) {
    const int r = t / F, f = t % F;
    xs[r][f] = r < nrows ? x[(size_t)(row0 + r) * F + f] : 0.f;
  }
  __syncthreads();
  for (int col = threadIdx.x; col < GC; col += blockDim.x) {
    float a1[PROJ_ROWS], a2[PROJ_ROWS];
#pragma unroll
    for (int r = 0; r < PROJ_ROWS; ++r) a1[r] = a2[r] = 0.f;
    for (int f = 0; f < F; ++f) {
      const float u = w1[(size_t)f * GC + col];
      const float v = w2[(size_t)f * GC + col];
#pragma unroll
      for (int r = 0; r < PROJ_ROWS; ++r) {
        a1[r] += xs[r][f] * u;
        a2[r] += xs[r][f] * v;
      }
    }
    const float c1 = b1[col], c2 = b2[col];
#pragma unroll
    for (int r = 0; r < PROJ_ROWS; ++r) {
      if (r < nrows) {
        y1[(size_t)(row0 + r) * GC + col] = a1[r] + c1;
        y2[(size_t)(row0 + r) * GC + col] = a2[r] + c2;
      }
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

}  // namespace

extern "C" {

const char* ggnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Fused conv forward. kn/vn [Ns, GC] and q/sk [Nd, GC] are scratch the
// caller allocates; out [Nd, GC]. Weights in the JAX package's layout:
// w [F, GC], b [GC], wl2 [G, C, C], bl2 [G, C], we [GC].
int edge_stage_forward(
    const float* x_src, int Ns, int Fs, const float* x_dst, int Nd, int Fd,
    const int* nbr, const float* elen, const float* nmask, int K,
    const float* wq, const float* bq, const float* wk, const float* bk,
    const float* wv, const float* bv, const float* wsk, const float* bsk,
    const float* wl2, const float* bl2, const float* we, int G, int C,
    float* kn, float* vn, float* q, float* sk, float* out, void* stream) {
  const int GC = G * C;
  if (Fs > MAX_F || Fd > MAX_F || Fs < 3 || Fd < 3 || GC > MAX_GC ||
      G > MAX_G || K < 1 || K > MAX_K)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();   // clear any stale error
  if (Ns > 0)
    node_proj2<<<(Ns + PROJ_ROWS - 1) / PROJ_ROWS, PROJ_THREADS, 0, s>>>(
        x_src, Ns, Fs, wk, bk, wv, bv, GC, kn, vn);
  if (Nd > 0) {
    node_proj2<<<(Nd + PROJ_ROWS - 1) / PROJ_ROWS, PROJ_THREADS, 0, s>>>(
        x_dst, Nd, Fd, wq, bq, wsk, bsk, GC, q, sk);
    const int rows = EDGES / K;
    const int threads = (GC + 31) / 32 * 32;
    edge_attn<<<(Nd + rows - 1) / rows, threads, 0, s>>>(
        x_src, Ns, Fs, x_dst, Nd, Fd, nbr, elen, nmask, K, rows, kn, vn, q,
        sk, wk, wv, wl2, bl2, we, G, C, out);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
