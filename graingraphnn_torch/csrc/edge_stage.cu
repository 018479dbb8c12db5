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
//   destinations) as ONE grouped launch, in 3xTF32: each operand split
//   into hi + lo TF32 parts, and lo*hi + hi*lo + hi*hi summed into fp32
//   accumulators, which keeps near-fp32 error. Bound: about evenly the
//   [N, 2 GC] fp32 outputs at the memory's rate and the three products at
//   the tensor cores' TF32 rate. The weights come pre-split (kernels/
//   edge_stage.py pack_tf32x3, built once per weight version, so no kernel
//   splits a weight): per product and 128-column slice a hi and a lo plane
//   as wgmma's K-major B operand without swizzle (depth the wider F padded
//   to 8; per k8 step 4096 contiguous bytes of 8 x 4 core matrices,
//   csrc/wgmma_tf32.cuh). A block owns one (product, slice): its two
//   planes (up to 2 x 64 KB) arrive by one bulk copy each and stay
//   resident while the block walks its row tiles of 64 on up to three
//   warpgroups, tile i on warpgroup i % WG, through a ring of one stage a
//   warpgroup on mbarriers (hopper_async.cuh; two stages a warpgroup do
//   not fit beside the planes, and three warpgroups on one stage each
//   measured faster than two on two). 64 rows of x are one contiguous run
//   of 64 F floats, brought in by one bulk copy of its 16-byte aligned
//   middle, the 0-3 values before and after it copied by the issuing
//   thread, so neither F nor x's base need be aligned. Each thread splits
//   its A fragments into hi and lo straight from the fp32 tile, two
//   k-steps at a time into two register sets, and issues wgmma m64n128k8
//   (A from registers, B from the resident planes) three times a k-step,
//   one group of products in flight while the next set is split. Once the
//   warpgroup has read its stage, its first thread issues the copy of its
//   next tile, in flight while this tile's last products and stores and
//   the other warpgroups' tiles run. The epilogue adds the bias and stores
//   straight from the accumulators: lane pairs swap halves so that each
//   group of 4 lanes stores 64 contiguous bytes of a row (16 rows of 32
//   bytes a store measured 16 % slower; staging the tile through shared
//   memory, whose bandwidth the products' B reads already load, no faster).
//   The grid follows the shapes: one wave of a tile a warpgroup on the
//   fewest warpgroups a block that fit it (the one-lane, halo and
//   partitioned convs); past that, persistent blocks of three warpgroups,
//   one wave, each a run of consecutive tiles.
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

#include "hopper_async.cuh"
#include "mma_tf32.cuh"
#include "wgmma_tf32.cuh"

namespace {

constexpr int MAX_F = 128;      // node feature width the kernels take
constexpr int MAX_C = 128;      // gate width edge_attn takes
constexpr int MAX_G = 8;
constexpr int MAX_K = 64;       // neighbor slots per row: two ballots of 32
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;

// node_proj tiling: warpgroups on 64 x 128 tiles, wgmma m64n128k8
constexpr int NP_BM = 64;                 // rows of a tile
constexpr int NP_BN = 128;                // columns of a block's slice
constexpr int NP_WG_MAX = 3;              // warpgroups a block
constexpr int NP_KSTEP_BYTES = NP_BN * 8 * 4;   // a k8 step of a W plane
constexpr int NP_SMEM_MAX = 232448;       // a block's shared memory on sm_90
constexpr int NP_KC = 2;                  // k-steps split into one register set
constexpr int NP_KSTEPS = MAX_F / 8;
static_assert(NP_KSTEPS % NP_KC == 0, "node_proj k chunks");

// A build with -DNODE_PROJ_PART=1 leaves out node_proj's products, and one
// with 2 its loads of x and its stores; they exist to time the parts
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

// the pack's layout (kernels/edge_stage.py builds it): the planes' depth
// (the wider F padded to 8), their column count, a plane's bytes
__host__ __device__ inline int np_fp(int Fs, int Fd) {
  return ((Fs > Fd ? Fs : Fd) + 7) & ~7;
}
__host__ __device__ inline int np_gcp(int GC) {
  return (GC + NP_BN - 1) / NP_BN * NP_BN;
}
__host__ __device__ inline int np_plane_bytes(int Fs, int Fd) {
  return np_fp(Fs, Fd) / 8 * NP_KSTEP_BYTES;
}

// Shared memory of a node_proj block of WG warpgroups: the hi and lo
// planes, the bias slice [NP_BN], a stage of NP_BM rows of x a warpgroup at
// the wider F (4 floats more, so a tile lands at x's offset from a 16-byte
// boundary), 1 + WG mbarriers (the planes, then each stage).
__host__ __device__ inline int np_stage_floats(int Fs, int Fd) {
  return NP_BM * (Fs > Fd ? Fs : Fd) + 4;
}
__host__ __device__ inline int np_smem(int Fs, int Fd, int WG) {
  return 2 * np_plane_bytes(Fs, Fd) + (NP_BN + WG * np_stage_floats(Fs, Fd)) * 4 +
         (1 + WG) * 8;
}

struct ProjSet {        // y_p [N, GC] = x [N, F] w_p [F, GC] + b_p, p = k, v, q, sk
  const float* x[2];    // x_src (k, v), x_dst (q, sk)
  int N[2], F[2];
  const uint32_t* w;    // the pack: per (p, slice) the hi, then the lo plane
  const float* b[4];
  float* y[4];
  int GC, T;            // gate width G*C, tiles a block
  int blocks[4];        // blocks of each product
};

// n floats from src to dst (dst at src's offset from a 16-byte boundary)
// on bar: the 16-byte blocks by the copy engine, the 0-3 floats before and
// after them here; the arrival comes last, so the phase completes when
// all have landed.
__device__ __forceinline__ void copy_floats(float* dst, const float* src, int n,
                                            uint64_t* bar) {
  const int lead = (16 - (int)(reinterpret_cast<uintptr_t>(src) & 15)) & 15;
  const int head = min(n, lead / 4), bulk = (n - head) & ~3;
  mbar_expect_tx(bar, bulk * 4);
  if (bulk > 0) bulk_copy_g2s(dst + head, src + head, bulk * 4, bar);
  for (int u = 0; u < head; ++u) dst[u] = src[u];
  for (int u = head + bulk; u < n; ++u) dst[u] = src[u];
  mbar_arrive(bar);
}

// One 128-column slice of one of the grouped products over T consecutive
// row tiles of 64: tile i of the block in stage i % WG, on warpgroup i % WG.
__global__ void __launch_bounds__(NP_WG_MAX * 128, 1) node_proj(ProjSet P) {
  extern __shared__ __align__(128) uint32_t np_smem_u[];
  int bi = blockIdx.x, p = 0;
  while (p < 3 && bi >= P.blocks[p]) bi -= P.blocks[p++];
  const int GC = P.GC, slices = np_gcp(GC) / NP_BN;
  const int s = bi % slices, t0 = (bi / slices) * P.T;
  const int xi = p >> 1, N = P.N[xi], F = P.F[xi];
  const float* x = P.x[xi];
  const int nt = min(P.T, (N + NP_BM - 1) / NP_BM - t0);
  const int WG = blockDim.x / 128;
  const int plane = np_plane_bytes(P.F[0], P.F[1]);
  const int stage = np_stage_floats(P.F[0], P.F[1]);
  const int col0 = s * NP_BN, ncols = min(NP_BN, GC - col0);
  unsigned char* whi = reinterpret_cast<unsigned char*>(np_smem_u);
  unsigned char* wlo = whi + plane;
  float* sb = reinterpret_cast<float*>(wlo + plane);       // [NP_BN] bias
  float* xs = sb + NP_BN;                                  // [WG][stage]
  uint64_t* bar = reinterpret_cast<uint64_t*>(xs + WG * stage);
  const int tid = threadIdx.x, wg = tid / 128, wt = tid % 128;
  // floats from x's base to the 16-byte boundary below it: every tile
  // (64 F floats) starts as far from one
  const int mis = (int)(reinterpret_cast<uintptr_t>(x) & 15) / 4;

  // tile i of the block into its stage
  auto issue = [&](int i) {
    const int t = t0 + i;
    uint64_t* b = &bar[1 + i % WG];
    if (NP_MEMORY) {
      copy_floats(xs + (i % WG) * stage + mis, x + (size_t)t * NP_BM * F,
                  min(NP_BM, N - t * NP_BM) * F, b);
    } else {
      mbar_arrive(b);
    }
  };
  if (tid == 0) {
    for (int i = 0; i <= WG; ++i) mbar_init(&bar[i], 1);
    mbar_fence_init();
    const uint32_t* w = P.w + (size_t)(p * slices + s) * 2 * (plane / 4);
    mbar_expect_tx(&bar[0], 2 * plane);
    bulk_copy_g2s(whi, w, plane, &bar[0]);
    bulk_copy_g2s(wlo, w + plane / 4, plane, &bar[0]);
    mbar_arrive(&bar[0]);
    for (int i = 0; i < WG && i < nt; ++i) issue(i);
  }
  for (int i = tid; i < NP_BN; i += blockDim.x)
    sb[i] = i < ncols ? P.b[p][col0 + i] : 0.f;

  const int warp = wt / 32, lane = wt % 32;
  const int g = lane >> 2, tq = lane & 3, r = warp * 16 + g;   // rows r, r + 8
  const int KS = (F + 7) / 8;                                   // k-steps
  float* y = P.y[p];
  const bool yvec = GC % 4 == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  __syncthreads();                        // the mbarriers and the bias

  for (int i = wg, j = 0; i < nt; i += WG, ++j) {
    const int row0 = (t0 + i) * NP_BM;
    mbar_wait(&bar[1 + wg], j & 1);
    if (j == 0) mbar_wait(&bar[0], 0);
    const float* xt = xs + wg * stage + mis;
    auto at = [&](int row, int k) { return k < F ? xt[row * F + k] : 0.f; };

    // per chunk of NP_KC k-steps: this thread's A fragments split into hi
    // and lo (zeros past F; rows past the tile's end are never stored),
    // then three products a k-step, lo*hi + hi*lo + hi*hi; a chunk's
    // products run while the next chunk is split into the other set
    float acc[64];
    if (!NP_PRODUCTS)
      for (int u = 0; u < 64; ++u) acc[u] = 0.f;
    uint32_t ah[2][NP_KC][4], al[2][NP_KC][4];
#pragma unroll
    for (int c = 0; c < NP_KSTEPS / NP_KC; ++c) {
      if (c * NP_KC >= KS) break;
      const int set = c & 1;
#pragma unroll
      for (int kk = 0; kk < NP_KC; ++kk) {
        const int k = (c * NP_KC + kk) * 8 + tq;
        split_tf32(at(r, k), ah[set][kk][0], al[set][kk][0]);
        split_tf32(at(r + 8, k), ah[set][kk][1], al[set][kk][1]);
        split_tf32(at(r, k + 4), ah[set][kk][2], al[set][kk][2]);
        split_tf32(at(r + 8, k + 4), ah[set][kk][3], al[set][kk][3]);
      }
      if ((c + 1) * NP_KC >= KS) {        // the stage is read: refill it
        wg_sync(wg);
        if (wt == 0 && i + WG < nt) issue(i + WG);
      }
      if (NP_PRODUCTS) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < NP_KC; ++kk) {
          const int ks = c * NP_KC + kk;
          if (ks < KS) {
            const uint64_t dh = wgmma_desc(whi + ks * NP_KSTEP_BYTES, 128, 256);
            const uint64_t dl = wgmma_desc(wlo + ks * NP_KSTEP_BYTES, 128, 256);
            wgmma_m64n128k8_tf32(acc, al[set][kk], dh, ks > 0);
            wgmma_m64n128k8_tf32(acc, ah[set][kk], dl, 1);
            wgmma_m64n128k8_tf32(acc, ah[set][kk], dh, 1);
          }
        }
        wgmma_commit();
        wgmma_wait1();
      }
    }
    if (NP_PRODUCTS) wgmma_wait0();

    // the bias, then rows out, 16 columns (two n8 blocks) at a time: lane
    // pairs swap halves so that the 4 lanes of a row group hold 16
    // consecutive columns of row r, then of row r + 8, 4 a lane (64
    // contiguous bytes of a row from each group of 4 lanes a store)
    const bool odd = tq & 1;
    const int n0 = 2 * tq + (odd ? 6 : 0);
#pragma unroll
    for (int m = 0; m < NP_BN / 16; ++m) {
      const float* d = acc + 8 * m;       // n8 blocks 2m (d[0..3]), 2m + 1 (d[4..7])
      const float p0 = __shfl_xor_sync(FULL, odd ? d[0] : d[4], 1);
      const float p1 = __shfl_xor_sync(FULL, odd ? d[1] : d[5], 1);
      const float p2 = __shfl_xor_sync(FULL, odd ? d[2] : d[6], 1);
      const float p3 = __shfl_xor_sync(FULL, odd ? d[3] : d[7], 1);
      const int n = 16 * m + n0;
      const float4 b = *reinterpret_cast<const float4*>(sb + n);
      const float v[2][4] = {
          {odd ? p0 : d[0], odd ? p1 : d[1], odd ? d[4] : p0, odd ? d[5] : p1},
          {odd ? p2 : d[2], odd ? p3 : d[3], odd ? d[6] : p2, odd ? d[7] : p3}};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + r + 8 * h;
        const float o[4] = {v[h][0] + b.x, v[h][1] + b.y, v[h][2] + b.z, v[h][3] + b.w};
        float* yr = y + (size_t)row * GC + col0 + n;
        if (!NP_MEMORY) {                 // keep the products
          if (o[0] == 12345.f) yr[0] = o[1] + o[2] + o[3];
        } else if (row < N && yvec && n < ncols) {
          *reinterpret_cast<float4*>(yr) = make_float4(o[0], o[1], o[2], o[3]);
        } else if (row < N) {
          for (int u = 0; u < 4 && n + u < ncols; ++u) yr[u] = o[u];
        }
      }
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

// node_proj's grid at these shapes: warpgroups a block, tiles a block,
// blocks of each product. One wave of a tile a warpgroup, on the fewest
// warpgroups a block that fit it in one wave (so a small conv spreads over
// as many SMs as it can: a block's warpgroups share one SM's tensor cores),
// returning 0 in branch; else persistent blocks of the most warpgroups
// whose stages fit in shared memory (NP_WG_MAX at the rollout's widths),
// one wave of them, each a run of T consecutive tiles of one product and
// slice, T the least that keeps the blocks within the wave (1 in branch).
struct NpPlan {
  int WG, T, blocks[4], total;
};

// blocks of WG warpgroups at these widths an SM holds (the last answer
// for each WG kept)
int np_per_sm(int WG, int Fs, int Fd, int* per_sm) {
  static int smem_of[NP_WG_MAX + 1], per_sm_of[NP_WG_MAX + 1];
  const int smem = np_smem(Fs, Fd, WG);
  if (smem != smem_of[WG]) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm_of[WG], node_proj, WG * 128, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_of[WG] = smem;
  }
  *per_sm = per_sm_of[WG] > 0 ? per_sm_of[WG] : 1;
  return 0;
}

int np_plan(int Ns, int Nd, int Fs, int Fd, int GC, NpPlan* plan, int* branch) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(node_proj, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 NP_SMEM_MAX);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int slices = np_gcp(GC) / NP_BN, N[2] = {Ns, Nd};
  int tiles[4], most = 0, all = 0;
  for (int i = 0; i < 4; ++i) {
    tiles[i] = (N[i >> 1] + NP_BM - 1) / NP_BM;
    most = tiles[i] > most ? tiles[i] : most;
    all += slices * tiles[i];
  }
  auto blocks = [&](int T) {
    int n = 0;
    for (int i = 0; i < 4; ++i) n += slices * ((tiles[i] + T - 1) / T);
    return n;
  };
  int WG = 1, per_sm = 1, T = 0;
  for (; WG <= NP_WG_MAX && np_smem(Fs, Fd, WG) <= NP_SMEM_MAX; ++WG) {
    const int err = np_per_sm(WG, Fs, Fd, &per_sm);
    if (err) return err;
    if (blocks(WG) <= per_sm * sms) {
      T = WG;
      break;
    }
  }
  *branch = 0;
  if (T == 0) {                          // persistent, on the widest blocks
    --WG;
    const int err = np_per_sm(WG, Fs, Fd, &per_sm);
    if (err) return err;
    const int wave = per_sm * sms;
    T = (all + wave - 1) / wave;
    while (T < most && blocks(T) > wave) ++T;
    *branch = 1;
  }
  *plan = {WG, T, {0, 0, 0, 0}, 0};
  for (int i = 0; i < 4; ++i) {
    plan->blocks[i] = slices * ((tiles[i] + T - 1) / T);
    plan->total += plan->blocks[i];
  }
  return 0;
}

int launch_node_proj(const float* x_src, int Ns, int Fs, const float* x_dst,
                     int Nd, int Fd, const uint32_t* wpack, const float* bq,
                     const float* bk, const float* bv, const float* bsk,
                     int GC, float* kn, float* vn, float* q, float* sk,
                     cudaStream_t s, int* branch) {
  int taken = -1;
  if (branch) *branch = taken;
  if ((reinterpret_cast<uintptr_t>(wpack) & 15) != 0) return cudaErrorMisalignedAddress;
  NpPlan plan;
  const int err = np_plan(Ns, Nd, Fs, Fd, GC, &plan, &taken);
  if (err) return err;
  if (plan.total == 0) return 0;
  ProjSet P{{x_src, x_dst}, {Ns, Nd}, {Fs, Fd}, wpack, {bk, bv, bq, bsk},
            {kn, vn, q, sk}, GC, plan.T,
            {plan.blocks[0], plan.blocks[1], plan.blocks[2], plan.blocks[3]}};
  node_proj<<<plan.total, plan.WG * 128, np_smem(Fs, Fd, plan.WG), s>>>(P);
  if (branch) *branch = taken;
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
// [Nd, GC]. wpack: the projections' TF32 hi and lo planes
// (kernels/edge_stage.py pack_tf32x3, 16-byte aligned); the biases, wk and
// wv (their position rows), wl2 [G, C, C], bl2 [G, C] and we [GC] in the
// JAX package's layout. branch, where not null, gets node_proj's grid: 0
// one wave, 1 persistent, -1 no launch.
int edge_stage_forward(
    const float* x_src, int Ns, int Fs, const float* x_dst, int Nd, int Fd,
    const int* nbr, const float* elen, const float* nmask, int K,
    const uint32_t* wpack, const float* bq, const float* bk, const float* bv,
    const float* bsk, const float* wk, const float* wv, const float* wl2,
    const float* bl2, const float* we, int G, int C, float* kn, float* vn,
    float* q, float* sk, float* out, void* stream, int* branch) {
  if (!takes(Fs, Fd, G, C, K)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();   // clear any stale error
  int err = launch_node_proj(x_src, Ns, Fs, x_dst, Nd, Fd, wpack, bq, bk, bv,
                             bsk, G * C, kn, vn, q, sk, s, branch);
  if (err) return err;
  err = launch_edge_attn({x_src, Ns, Fs, x_dst, Nd, Fd, nbr, elen, nmask, K, kn,
                          vn, q, sk, wk, wv, wl2, bl2, we, G, C, out}, s);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

// The node projections alone (one node_proj launch): kn = x_src wk + bk,
// vn = x_src wv + bv, q = x_dst wq + bq, sk = x_dst wsk + bsk, the
// weights as wpack holds them; branch as above.
int edge_node_proj(
    const float* x_src, int Ns, int Fs, const float* x_dst, int Nd, int Fd,
    const uint32_t* wpack, const float* bq, const float* bk, const float* bv,
    const float* bsk, int GC, float* kn, float* vn, float* q, float* sk,
    void* stream, int* branch) {
  if (!takes_proj(Fs, Fd)) return cudaErrorInvalidValue;
  cudaGetLastError();
  const int err = launch_node_proj(x_src, Ns, Fs, x_dst, Nd, Fd, wpack, bq,
                                   bk, bv, bsk, GC, kn, vn, q, sk,
                                   static_cast<cudaStream_t>(stream), branch);
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
