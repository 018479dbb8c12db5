// Fused periodic graph-transformer conv (PeriodConv), fp32, for Hopper.
//
// Replaces the TPU kernels graingraphnn_tpu/kernels/edge_stage.py::_kernel
// (K < 8: push and connect, K = 3) and ::_kernel_flat (K >= 8: pull,
// K = RING_MAX = 16 on the device rollout; the host engine sizes the ring
// from the live degree in 8-wide buckets, here up to 64), both launched
// by apply_period_conv_pallas. Per
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
// edge_attn: the gathers, the softmax and the value MLP's second layer.
//   Bound: bytes. Each input is read once from device memory, but the
//   gathers read a source's K and V rows once per edge, from L2, so the
//   L2 traffic is about three times those bytes. The second layer is
//   linear, so the alpha-weighted sum moves inside it:
//     sum_k alpha_k (relu(pre_v_k) Wl2 + bl2 + len_k We)
//       = (sum_k alpha_k relu(pre_v_k)) Wl2 + bl2 sum_k alpha_k + We sum_k alpha_k len_k
//   and the l2 product runs once per destination ROW, not once per edge.
//   Every gate is independent, so the grid is (row tiles, gates) and a
//   block holds only its gate's Wl2[g] (C x C, <= 68 KB), staged into
//   shared memory by cp.async while the rows are gathered. First a thread
//   per slot of the tile writes a slot table to shared memory: the source
//   row of a live slot (-1 where masked) and d = (shift - x_i[:3], len).
//   Then a warp per destination row: a ballot over each 32 slots of the
//   row's table gives the live slots (in ascending order, anywhere in the
//   row); the K and V row slices of up to 8 live slots are all loaded
//   before any is used,
//   lane l owning gate columns l, l + 32, ...; the logit is q . K[j]
//   reduced by shuffles plus d . (Wk[:3] q, We q), whose four sums are
//   taken once per row; the softmax runs online over those chunks in
//   registers; and the row's alpha-weighted relu(pre_v), split into TF32
//   hi and lo parts once, sum alpha len and sum alpha go to shared memory.
//   Masked slots cost nothing. Then the tile's rows times Wl2[g] on
//   mma.sync m16n8k8 in 3xTF32, and the epilogue (+ bl2 sum alpha + We
//   sum alpha len + skip) through shared memory in rows of 16-byte stores.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_tf32.cuh"

namespace {

constexpr int MAX_F = 128;      // node feature width the kernels take
constexpr int MAX_C = 128;      // gate width edge_attn takes
constexpr int MAX_G = 8;
constexpr int MAX_K = 64;       // neighbor slots per row: two ballots of 32
constexpr unsigned FULL = 0xffffffffu;
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

// edge_attn tiling: EA_ROWS destination rows per block, EA_WARPS warps
#ifndef EA_ROWS
#define EA_ROWS 32
#endif
#ifndef EA_WARPS
#define EA_WARPS 16
#endif
constexpr int EA_R = EA_ROWS;
constexpr int EA_THREADS = EA_WARPS * 32;
constexpr int EA_MT = EA_R / 16;                          // m16 tiles
constexpr int EA_WPM = EA_WARPS / EA_MT;                  // warps per m16 tile
constexpr int EA_NT = (MAX_C / 8 + EA_WPM - 1) / EA_WPM;  // n8 tiles per warp
static_assert(EA_R % 16 == 0 && EA_R % EA_WARPS == 0 && EA_WARPS % EA_MT == 0,
              "edge_attn tiles");

// Likewise -DEDGE_ATTN_PART=1 leaves out edge_attn's l2 product, and 2
// everything but Wl2's staging and the product.
#ifndef EDGE_ATTN_PART
#define EDGE_ATTN_PART 0
#endif
constexpr bool EA_PRODUCT = EDGE_ATTN_PART != 1;
constexpr bool EA_GATHER = EDGE_ATTN_PART != 2;

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

struct Attn {                             // edge_attn's inputs and output
  const float* x_src; int Ns, Fs;
  const float* x_dst; int Nd, Fd;
  const int* nbr; const float* elen; const float* nmask; int K;
  const float* kn; const float* vn; const float* q; const float* sk;
  const float* wk; const float* wv; const float* wl2; const float* bl2;
  const float* we; int G, C;
  float* out;
};

// Shared memory of an edge_attn block at gate width C and K slots: Wl2[g]
// over Cp x Cp (C padded to a multiple of 8) with row stride ea_ws, so the
// B fragment rows k, k+1, k+2, k+3 lie 8 or 24 banks apart; the tile's
// rows (below); sum alpha len
// and sum alpha per row; Wk[:3] and We of the gate, zero-padded to Cp;
// the slot table (shift - x_i[:3], len) as float4 and the source row (-1
// where masked). The rows are kept split into
// their TF32 hi and lo parts, each with stride Cp + 4 (A fragment rows 4
// banks apart).
__host__ __device__ inline int ea_cp(int C) { return (C + 7) & ~7; }
__host__ __device__ inline int ea_ws(int Cp) { return Cp % 16 ? Cp : Cp + 8; }
__host__ __device__ inline int ea_smem(int C, int K) {
  const int Cp = ea_cp(C);
  return (Cp * ea_ws(Cp) + 2 * EA_R * (Cp + 4) + 2 * EA_R + 4 * Cp + 5 * EA_R * K) *
         (int)sizeof(float);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// EA_R destination rows and gate blockIdx.y. CPL = ceil(C / 32) columns
// per lane; CH live slots gathered together; NSEG ballots of 32 slots
// cover K <= 32 * NSEG. K = 3 at C <= 96 fits 64 registers, so 1024
// threads share an SM.
template <int CPL, int CH, int NSEG>
__global__ void __launch_bounds__(EA_THREADS, CH == 3 && CPL <= 3 ? 1024 / EA_THREADS : 1)
    edge_attn(Attn A) {
  extern __shared__ __align__(16) float ea_smem_f[];
  const int C = A.C, GC = A.G * C, g = blockIdx.y, K = A.K;
  const int Cp = ea_cp(C), WS = ea_ws(Cp), AS = Cp + 4;
  float* ws = ea_smem_f;                  // [Cp][WS] Wl2[g], zero-padded
  float* as = ws + Cp * WS;               // [EA_R][AS] the product
  uint32_t* ah_s = reinterpret_cast<uint32_t*>(as);       // [EA_R][AS] rows, hi
  uint32_t* al_s = ah_s + EA_R * AS;                      // [EA_R][AS] rows, lo
  float* s_len = as + 2 * EA_R * AS;      // [EA_R] sum alpha len
  float* s_sum = s_len + EA_R;            // [EA_R] sum alpha
  float* s_wq = s_sum + EA_R;             // [4][Cp] Wk[:3] and We of the gate
  float4* s_d = reinterpret_cast<float4*>(s_wq + 4 * Cp);  // [EA_R * K]
  int* s_j = reinterpret_cast<int*>(s_d + EA_R * K);       // [EA_R * K]
  const int row0 = blockIdx.x * EA_R;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // Wl2[g] into shared memory; the copies land while the rows are gathered
  const float* w2 = A.wl2 + (size_t)g * C * C;
  const bool wvec = C % 4 == 0 && (reinterpret_cast<uintptr_t>(A.wl2) & 15) == 0;
  for (int i = tid; i < Cp * (Cp / 4); i += EA_THREADS) {
    const int k = i / (Cp / 4), n = (i % (Cp / 4)) * 4;
    float* dst = ws + k * WS + n;
    const float* src = w2 + (size_t)k * C + n;
    if (wvec && k < C && n + 4 <= C) {
      cp_async16(dst, src);
    } else {
      for (int u = 0; u < 4; ++u) {
        if (k < C && n + u < C) cp_async4(dst + u, src + u);
        else dst[u] = 0.f;
      }
    }
  }

  // the tile's slot table, a thread per slot: the source row of a live
  // slot and (shift - x_i[:3], len), with which x_j' Wk = K[j] + d Wk[:3]
  for (int e = tid; EA_GATHER && e < EA_R * K; e += EA_THREADS) {
    const int i = row0 + e / K;
    const size_t at = (size_t)row0 * K + e;
    int j = -1;
    float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < A.Nd) {
      const float m = A.nmask[at], len = A.elen[at];
      const int jj = A.nbr[at];
      if (m > 0.f) {
        j = jj < 0 || jj >= A.Ns ? 0 : jj;
        float dd[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float xi = A.x_dst[(size_t)i * A.Fd + c];
          const float rel = A.x_src[(size_t)j * A.Fs + c] - xi;
          dd[c] = (rel < -0.5f ? 1.f : 0.f) - (rel > 0.5f ? 1.f : 0.f) - xi;
        }
        d = make_float4(dd[0], dd[1], dd[2], len);
      }
    }
    s_j[e] = j;
    s_d[e] = d;
  }
  for (int e = tid; e < 4 * Cp; e += EA_THREADS) {
    const int d = e / Cp, c = e % Cp;
    s_wq[e] = c >= C ? 0.f : d < 3 ? A.wk[(size_t)d * GC + g * C + c] : A.we[g * C + c];
  }

  // Wv[:3] at this lane's gate columns c = lane + 32 u
  float wv0[CPL], wv1[CPL], wv2[CPL];
#pragma unroll
  for (int u = 0; u < CPL; ++u) {
    const int c = lane + 32 * u, col = g * C + c;
    const bool ok = c < C;
    wv0[u] = ok ? A.wv[col] : 0.f;
    wv1[u] = ok ? A.wv[GC + col] : 0.f;
    wv2[u] = ok ? A.wv[2 * GC + col] : 0.f;
  }
  const float inv_sqrt_c = 1.f / sqrtf((float)C);
  __syncthreads();

  // a warp per destination row, over its live slots only. The logit of
  // slot k is (q . K[j] + d_k . (Wk[:3] q, We q)) / sqrt(C), d_k = (shift
  // - x_i[:3], len): the four sums over q are taken once per row.
  for (int r = warp; EA_GATHER && r < EA_R; r += EA_WARPS) {
    const int i = row0 + r;
    const int* sj = s_j + r * K;
    const float4* sd = s_d + r * K;
    float qv[CPL], a[CPL], qw[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
      const int c = lane + 32 * u;
      qv[u] = i < A.Nd && c < C ? A.q[(size_t)i * GC + g * C + c] : 0.f;
      a[u] = 0.f;
      if (c < Cp)
#pragma unroll
        for (int d = 0; d < 4; ++d) qw[d] += qv[u] * s_wq[d * Cp + c];
    }
#pragma unroll
    for (int d = 0; d < 4; ++d) qw[d] = warp_sum(qw[d]);

    // online softmax over chunks of CH live slots, in ascending slot order:
    // slots s0 .. s0 + 31 of each ballot, the state carried across ballots
    float mx = NEG, den = 0.f, sl = 0.f;
    for (int s0 = 0; s0 < 32 * NSEG; s0 += 32) {
      const unsigned live = __ballot_sync(FULL, s0 + lane < K && sj[s0 + lane] >= 0);
      for (unsigned rem = live; rem;) {
        int ks[CH];
        bool on[CH];
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          on[c] = rem != 0u;
          ks[c] = on[c] ? s0 + __ffs((int)rem) - 1 : 0;
          rem &= rem - 1u;
        }
        float kv[CH][CPL], vv[CH][CPL];
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const size_t at = (size_t)sj[ks[c]] * GC + g * C;
#pragma unroll
          for (int u = 0; u < CPL; ++u) {
            const int cc = lane + 32 * u;
            kv[c][u] = vv[c][u] = 0.f;
            if (on[c] && cc < C) {
              kv[c][u] = A.kn[at + cc];
              vv[c][u] = A.vn[at + cc];
            }
          }
        }
        float lg[CH], lc[CH], cm = NEG;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          lg[c] = NEG;
          lc[c] = 0.f;
          if (!on[c]) continue;               // the same for the whole warp
          const float4 d = sd[ks[c]];
          float part = 0.f;
#pragma unroll
          for (int u = 0; u < CPL; ++u) {
            part += qv[u] * kv[c][u];
            vv[c][u] = fmaxf(vv[c][u] + d.x * wv0[u] + d.y * wv1[u] + d.z * wv2[u], 0.f);
          }
          lg[c] = (warp_sum(part) + d.x * qw[0] + d.y * qw[1] + d.z * qw[2] + d.w * qw[3])
              * inv_sqrt_c;
          lc[c] = d.w;
          cm = fmaxf(cm, lg[c]);
        }
        const float mnew = fmaxf(mx, cm), scale = expf(mx - mnew);
        den *= scale;
        sl *= scale;
#pragma unroll
        for (int u = 0; u < CPL; ++u) a[u] *= scale;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          if (!on[c]) continue;
          const float e = expf(lg[c] - mnew);
          den += e;
          sl += e * lc[c];
#pragma unroll
          for (int u = 0; u < CPL; ++u) a[u] += e * vv[c][u];
        }
        mx = mnew;
      }
    }

    // the row's sum alpha relu(pre_v) (zero past C, and on a row with no
    // live slot, whose output is its skip), split once for the product;
    // sum alpha len and sum alpha
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
      const int cc = lane + 32 * u;
      uint32_t hi, lo;
      split_tf32(den > 0.f ? a[u] / den : 0.f, hi, lo);
      if (cc < Cp) {
        ah_s[r * AS + cc] = hi;
        al_s[r * AS + cc] = lo;
      }
    }
    if (lane == 0) {
      s_len[r] = den > 0.f ? sl / den : 0.f;
      s_sum[r] = den > 0.f ? 1.f : 0.f;
    }
  }
  if (!EA_GATHER) {
    for (int i = tid; i < EA_R * (2 * AS + 2); i += EA_THREADS) as[i] = 0.f;
  }
  cp_async_wait_all();
  __syncthreads();

  // the tile's rows times Wl2[g] in 3xTF32: warp w takes m16 tile
  // w % EA_MT and its n8 column tiles w / EA_MT + EA_WPM t
  const int gr = lane >> 2, tq = lane & 3, n8 = Cp / 8;
  const int mt = warp % EA_MT, wn = warp / EA_MT;
  float acc[EA_NT][4];
#pragma unroll
  for (int t = 0; t < EA_NT; ++t)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[t][u] = 0.f;
  for (int k0 = 0; EA_PRODUCT && wn < n8 && k0 < Cp; k0 += 8) {
    const int at = (mt * 16 + gr) * AS + k0 + tq;
    const uint32_t ah[4] = {ah_s[at], ah_s[at + 8 * AS], ah_s[at + 4], ah_s[at + 8 * AS + 4]};
    const uint32_t al[4] = {al_s[at], al_s[at + 8 * AS], al_s[at + 4], al_s[at + 8 * AS + 4]};
#pragma unroll
    for (int t = 0; t < EA_NT; ++t) {
      const int nt = wn + t * EA_WPM;
      if (nt >= n8) break;
      const float* wb = ws + (k0 + tq) * WS + nt * 8 + gr;
      uint32_t bh[2], bl[2];
      split_tf32(wb[0], bh[0], bl[0]);
      split_tf32(wb[4 * WS], bh[1], bl[1]);
      mma_tf32(acc[t], al, bh);
      mma_tf32(acc[t], ah, bl);
      mma_tf32(acc[t], ah, bh);
    }
  }
  __syncthreads();                        // every warp has read the rows
  if (EA_PRODUCT) {
#pragma unroll
    for (int t = 0; t < EA_NT; ++t) {
      const int nt = wn + t * EA_WPM;
      if (nt >= n8) break;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        as[(mt * 16 + gr + (u >> 1) * 8) * AS + nt * 8 + 2 * tq + (u & 1)] = acc[t][u];
    }
  }
  __syncthreads();

  // out = product + bl2 sum alpha + We sum alpha len + skip, in rows of
  // 16-byte stores where aligned
  const int nrows = min(EA_R, A.Nd - row0), cq = (C + 3) / 4;
  const float* b2 = A.bl2 + g * C;
  const float* wg = A.we + g * C;
  const bool vec = C % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(A.out) | reinterpret_cast<uintptr_t>(A.sk) |
        reinterpret_cast<uintptr_t>(A.bl2) | reinterpret_cast<uintptr_t>(A.we)) & 15) == 0;
  for (int i = tid; i < nrows * cq; i += EA_THREADS) {
    if (!EA_GATHER && acc[0][0] != 12345.f) continue;   // keep the products
    const int r = i / cq, c = (i % cq) * 4;
    const float* o = as + r * AS + c;
    const float sl = s_len[r], sa = s_sum[r];
    const size_t at = (size_t)(row0 + r) * GC + g * C + c;
    if (vec) {
      const float4 s = *reinterpret_cast<const float4*>(A.sk + at);
      const float4 b = *reinterpret_cast<const float4*>(b2 + c);
      const float4 e = *reinterpret_cast<const float4*>(wg + c);
      *reinterpret_cast<float4*>(A.out + at) = make_float4(
          o[0] + b.x * sa + e.x * sl + s.x, o[1] + b.y * sa + e.y * sl + s.y,
          o[2] + b.z * sa + e.z * sl + s.z, o[3] + b.w * sa + e.w * sl + s.w);
    } else {
      for (int u = 0; u < 4 && c + u < C; ++u)
        A.out[at + u] = o[u] + b2[c + u] * sa + wg[c + u] * sl + A.sk[at + u];
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

template <int CPL, int CH, int NSEG>
int launch_attn(const Attn& A, cudaStream_t s) {
  // the attribute covers the widest C of this CPL at the largest K any call
  // has asked for (16 at least), and is raised when a call asks for more
  static int k_set = 0;
  if (A.K > k_set) {
    const int k = A.K > 16 ? A.K : 16;
    const cudaError_t err = cudaFuncSetAttribute(
        edge_attn<CPL, CH, NSEG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        ea_smem(32 * CPL, k));
    if (err != cudaSuccess) return static_cast<int>(err);
    k_set = k;
  }
  edge_attn<CPL, CH, NSEG><<<dim3((A.Nd + EA_R - 1) / EA_R, A.G), EA_THREADS,
                              ea_smem(A.C, A.K), s>>>(A);
  return 0;
}

// K = 3: one chunk of 3; K <= 32: chunks of 8 under one ballot; else two
template <int CPL>
int launch_cpl(const Attn& A, cudaStream_t s) {
  if (A.K <= 3) return launch_attn<CPL, 3, 1>(A, s);
  if (A.K <= 32) return launch_attn<CPL, 8, 1>(A, s);
  return launch_attn<CPL, 8, 2>(A, s);
}

int launch_edge_attn(const Attn& A, cudaStream_t s) {
  if (A.Nd <= 0) return 0;
  switch ((A.C + 31) / 32) {
    case 1: return launch_cpl<1>(A, s);
    case 2: return launch_cpl<2>(A, s);
    case 3: return launch_cpl<3>(A, s);
    case 4: return launch_cpl<4>(A, s);
  }
  return cudaErrorInvalidValue;
}

bool takes_proj(int Fs, int Fd) {
  return Fs <= MAX_F && Fd <= MAX_F && Fs >= 3 && Fd >= 3;
}

bool takes(int Fs, int Fd, int G, int C, int K) {
  return takes_proj(Fs, Fd) && G >= 1 && G <= MAX_G && C >= 1 && C <= MAX_C &&
         K >= 1 && K <= MAX_K;
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
  int err = launch_node_proj(x_src, Ns, Fs, x_dst, Nd, Fd, wq, bq, wk, bk, wv,
                             bv, wsk, bsk, G * C, kn, vn, q, sk, s);
  if (err) return err;
  err = launch_edge_attn({x_src, Ns, Fs, x_dst, Nd, Fd, nbr, elen, nmask, K, kn,
                          vn, q, sk, wk, wv, wl2, bl2, we, G, C, out}, s);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

// The node projections alone (one node_proj launch): kn = x_src wk + bk,
// vn = x_src wv + bv, q = x_dst wq + bq, sk = x_dst wsk + bsk.
int edge_node_proj(
    const float* x_src, int Ns, int Fs, const float* x_dst, int Nd, int Fd,
    const float* wq, const float* bq, const float* wk, const float* bk,
    const float* wv, const float* bv, const float* wsk, const float* bsk,
    int GC, float* kn, float* vn, float* q, float* sk, void* stream) {
  if (!takes_proj(Fs, Fd)) return cudaErrorInvalidValue;
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
  const int err = launch_edge_attn(
      {x_src, Ns, Fs, x_dst, Nd, Fd, nbr, elen, nmask, K, kn, vn, q, sk, wk,
       wv, wl2, bl2, we, G, C, out},
      static_cast<cudaStream_t>(stream));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
