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
//   What held the one-block-a-(tile, gate) design back (PERF.md): four
//   blocks built each tile's slot table, each block staged its gate's Wl2
//   for 32 rows, and each ran table, rows, product and epilogue in turn
//   behind block barriers, at two blocks an SM. Design: a block an SM,
//   walking row tiles of 16 (tiles b, b + blocks, ..., so the blocks at work
//   hold neighbouring tiles, whose sources share L2) for a group of gates
//   whose Wl2 lands once by one bulk copy (kernels/edge_stage.py pack_l2
//   orders it as mma.sync's B fragments) and stays resident for the launch,
//   in three warp roles on mbarrier rings (hopper_async.cuh), so that the
//   next tiles' tables and gathers are in flight while a tile's product
//   and epilogue run:
//   - EA_TW table warps build each tile's slot table once for all the
//     block's gates, EA_ST tiles ahead (the source row of a live slot, -1
//     where masked, and d = (shift - x_i[:3], len)), and ask L2 for the
//     tile's q and skip rows;
//   - EA_GW gather warps, a warp a (row, gate): a ballot over each 32 slots
//     of the row's table gives the live slots (in ascending order,
//     anywhere in the row); q and the K and V row slices of up to CH live
//     slots are loaded together before any is used, lane l owning gate
//     columns l, l + 32, ...; the logit is q . K[j] plus d . (Wk[:3] q, We
//     q), all of a chunk's sums and q's four reduced over the warp at once
//     (warp_sums); the softmax runs online over the chunks in registers;
//     the row's alpha-weighted relu(pre_v), sum alpha len and sum alpha go
//     to one of EA_SA stages. Masked slots cost nothing;
//   - EA_PW product warps multiply a stage's 16 rows by Wl2[g] on mma.sync
//     m16n8k8 in 3xTF32 (splits of four instructions, split_tf32_finite;
//     each k-step's products in three waves of independent ones) and store
//     out (+ bl2 sum alpha + We sum alpha len + skip) from the
//     accumulators.
//   The grid follows the shapes: a conv whose (tile, gate) pairs fill at
//   most EA_SMALL waves (one lane, halo stripes, partitioned blocks, the
//   host engine) takes one gate a block, spread over the SMs; a larger one
//   the widest gate group that fits (all four at the rollout's widths). A
//   block of a single tile has all its gather and product warps gather,
//   then multiply.

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

// edge_attn: persistent blocks of EA_GW gather warps, EA_PW product warps
// and EA_TW table warps, on row tiles of EA_R; -DEA_GW and -DEA_PW build
// variants (scripts/torch_kernel_probe.py)
constexpr int EA_R = 16;                  // rows of a tile: one m16 tile
#ifndef EA_GW
#define EA_GW 16
#endif
#ifndef EA_PW
#define EA_PW 8
#endif
constexpr int EA_TW = 2;
// EA_STAMP(i, on) marks point i of an edge_attn block where `on` holds
// (scripts/edge_attn_phase_trace.py builds a copy of this source with it
// defined to record the time on lane 0); in the kernels' own build it is
// empty
#ifndef EA_STAMP
#define EA_STAMP(i, on)
#endif
constexpr int EA_THREADS = (EA_GW + EA_PW + EA_TW) * 32;
constexpr int EA_CH = 4;                  // live slots gathered together at K > 3
                                          // (8 spilled at 72 registers)
constexpr int EA_NTW = 6;                 // n8 column tiles of a product unit
constexpr int EA_SMALL = 8;               // waves of one-gate blocks a small conv fills
constexpr int EA_TB = 4;                  // slots a table lane has in flight
constexpr int EA_ST = 2, EA_SA = 2;       // stages of the tables and the sums
constexpr int EA_TFULL = 0, EA_TEMPTY = EA_ST, EA_AFULL = 2 * EA_ST,
              EA_AEMPTY = 2 * EA_ST + EA_SA, EA_WREADY = 2 * EA_ST + 2 * EA_SA,
              EA_BARS = EA_WREADY + 1;    // the mbarriers
constexpr int EA_SMEM_MAX = NP_SMEM_MAX;

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

// edge_attn's grid: GB gates a block, `groups` = ceil(G / GB) gate groups,
// `tiles` row tiles; block b takes gate group b % groups and the row tiles
// b / groups + i * (gridDim.x / groups), i = 0, 1, ... (so the blocks at
// work at any time hold neighbouring tiles, whose sources share L2).
struct EaGrid {
  int GB, groups, tiles;
};

// Shared memory of an edge_attn block of GB gates at gate width C and K
// slots, as byte offsets: the slot tables, EA_ST stages of (shift -
// x_i[:3], len) as float4 and the source row (-1 where masked); Wl2 of the
// block's gates in mma.sync's B fragment order, [gate][k-step][n8 tile]
// [lane][2] over C padded to Cp, a multiple of 8 (a lane's two values
// adjacent: one conflict-free 8-byte load a fragment); Wk[:3] and We of
// those gates, [4][GB Cp]; the rows' alpha-weighted sums, EA_SA stages of
// [EA_R][GB Cp + 4] (A fragment rows 4 banks apart); sum alpha len and sum
// alpha per stage, row and gate; the mbarriers.
struct EaLayout {
  int GB, Cp, AS, td, tj, wl2, wq, a, ls, bar, bytes;
};
__host__ __device__ inline EaLayout ea_layout(int GB, int C, int K) {
  EaLayout L;
  L.GB = GB;
  L.Cp = (C + 7) & ~7;
  L.AS = GB * L.Cp + 4;
  int o = 0;
  L.td = o;  o += EA_ST * EA_R * K * 16;
  L.wl2 = o; o += GB * L.Cp * L.Cp * 4;
  L.wq = o;  o += 4 * GB * L.Cp * 4;
  L.a = o;   o += EA_SA * EA_R * L.AS * 4;
  L.ls = o;  o += EA_SA * EA_R * GB * 2 * 4;
  L.tj = o;  o += EA_ST * EA_R * K * 4;
  L.bar = (o + 7) & ~7;
  L.bytes = L.bar + EA_BARS * 8;
  return L;
}

// v[0..N-1] summed over the warp, each total in every lane, N a power of
// two up to 32: a transposed reduction (at each step lanes keep half of
// their values and add their partner's other half: N - 1 shuffles, then
// 5 - log2 N to finish) and N broadcasts, against 5 N for N butterflies;
// the shuffles of a step are independent, so they overlap.
template <int N>
__device__ __forceinline__ void warp_sums(float v[N]) {
  const int lane = threadIdx.x & 31;
  float w[N];
#pragma unroll
  for (int i = 0; i < N; ++i) w[i] = v[i];
  int mask = 16;
#pragma unroll
  for (int n = N; n > 1; n /= 2, mask /= 2) {
    const bool up = lane & mask;
#pragma unroll
    for (int i = 0; i < n / 2; ++i)
      w[i] = (up ? w[i + n / 2] : w[i]) +
             __shfl_xor_sync(FULL, up ? w[i] : w[i + n / 2], mask);
  }
  for (; mask > 0; mask /= 2) w[0] += __shfl_xor_sync(FULL, w[0], mask);
  // lane l holds the total of the index whose bits, high to low, are l's
  // bits 4, 3, ... (one a halving step)
#pragma unroll
  for (int i = 0; i < N; ++i) {
    int src = 0;
#pragma unroll
    for (int k = 1, m = 16; k < N; k *= 2, m /= 2)
      if (i & (N / 2 / k)) src |= m;
    v[i] = __shfl_sync(FULL, w[0], src);
  }
}

// the least power of two >= n
__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

// This warp's arrival on bar: its lanes' shared-memory writes ordered
// before lane 0's arrive, which releases them (one arrival a warp)
__device__ __forceinline__ void warp_arrive(uint64_t* bar, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(bar);
}

// x split into TF32 hi and lo parts as split_tf32 does for a finite x
// (cvt.rna's carry into the kept bits, without its checks for infinities
// and NaNs, which the weights and sums never are), each part as mma.sync
// reads it: the 13 bits below TF32, which it ignores, left as they fall.
// Four instructions, against nine.
__device__ __forceinline__ void split_tf32_finite(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) + 0x1000u;
  lo = __float_as_uint(x - __uint_as_float(hi & 0xffffe000u)) + 0x1000u;
}

// Where a block's roles meet: its gate group, its tiles tf, tf + ts, ...
// (nt of them), and its shared memory.
struct EaBlock {
  int g0, ng, tf, ts, nt;
  unsigned char* sm;
  EaLayout L;
  uint64_t* bar;
};

// A table warp, tw of EA_TW: Wk[:3] and We of the block's gates once, then
// each tile's slot table into stage i % EA_ST, a lane a slot, EA_TB slots
// a lane in flight (their mask, length and source row, then both ends'
// positions): the source row of a live slot and (shift - x_i[:3], len),
// with which x_j' Wk = K[j] + d Wk[:3].
__device__ __forceinline__ void ea_table(const Attn& A, const EaBlock& B, int tw, int lane) {
  const int C = A.C, GC = A.G * C, K = A.K, Cp = B.L.Cp, W = B.L.GB * Cp;
  float* s_wq = reinterpret_cast<float*>(B.sm + B.L.wq);
  for (int e = tw * 32 + lane; e < 4 * W; e += EA_TW * 32) {
    const int d = e / W, gl = (e % W) / Cp, c = e % Cp, g = B.g0 + gl;
    if (gl >= B.ng || c >= C)
      s_wq[e] = 0.f;
    else
      cp_async4(s_wq + e, d < 3 ? A.wk + (size_t)d * GC + g * C + c : A.we + g * C + c);
  }
  for (int i = 0; i < B.nt; ++i) {
    const int s = i % EA_ST;
    if (i >= EA_ST) mbar_wait(&B.bar[EA_TEMPTY + s], (i / EA_ST - 1) & 1);
    const int row0 = (B.tf + i * B.ts) * EA_R;
    const size_t at0 = (size_t)row0 * K;
    float4* sd = reinterpret_cast<float4*>(B.sm + B.L.td) + s * EA_R * K;
    int* sj = reinterpret_cast<int*>(B.sm + B.L.tj) + s * EA_R * K;
    for (int e0 = tw * 32 * EA_TB; EA_GATHER && e0 < EA_R * K; e0 += EA_TW * 32 * EA_TB) {
      int j[EA_TB];
      float m[EA_TB], len[EA_TB];
#pragma unroll
      for (int b = 0; b < EA_TB; ++b) {
        const int e = e0 + 32 * b + lane;
        const bool ok = e < EA_R * K && row0 + e / K < A.Nd;
        m[b] = ok ? A.nmask[at0 + e] : 0.f;
        len[b] = ok ? A.elen[at0 + e] : 0.f;
        j[b] = ok ? A.nbr[at0 + e] : 0;
      }
      float xs[EA_TB][3], xd[EA_TB][3];
#pragma unroll
      for (int b = 0; b < EA_TB; ++b) {
        const int e = e0 + 32 * b + lane, r = row0 + e / K;
        j[b] = m[b] > 0.f ? (j[b] < 0 || j[b] >= A.Ns ? 0 : j[b]) : -1;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          xs[b][c] = j[b] >= 0 ? A.x_src[(size_t)j[b] * A.Fs + c] : 0.f;
          xd[b][c] = j[b] >= 0 ? A.x_dst[(size_t)r * A.Fd + c] : 0.f;
        }
      }
#pragma unroll
      for (int b = 0; b < EA_TB; ++b) {
        const int e = e0 + 32 * b + lane;
        if (e >= EA_R * K) break;
        float dd[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float rel = xs[b][c] - xd[b][c];
          dd[c] = (rel < -0.5f ? 1.f : 0.f) - (rel > 0.5f ? 1.f : 0.f) - xd[b][c];
        }
        sj[e] = j[b];
        sd[e] = j[b] >= 0 ? make_float4(dd[0], dd[1], dd[2], len[b])
                          : make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    // the tile's q and skip rows into L2 (0-4 % off the benchmark's K = 3
    // convs, PERF.md)
    const int lines = (B.ng * C * 4 + 127) / 128 + 1, rows = min(EA_R, A.Nd - row0);
    for (int e = tw * 32 + lane; e < 2 * rows * lines; e += EA_TW * 32) {
      const int r = (e / lines) % rows, l = e % lines;
      const float* base = (e < rows * lines ? A.q : A.sk) + (size_t)(row0 + r) * GC + B.g0 * C;
      prefetch_l2(reinterpret_cast<const char*>(base) + min(128 * l, B.ng * C * 4 - 4));
    }
    if (i == 0) cp_async_wait_all();     // Wk[:3] and We landed
    EA_STAMP(1, tw == 0 && i == 0);
    warp_arrive(&B.bar[EA_TFULL + s], lane);
  }
}

// Worker w of nw's items of a tile, (row, gate) pairs w, w + nw, ... over
// the tile's rows and the block's gates; a warp an item over its live
// slots only, the sums into stage sa. CPL = ceil(C / 32) columns a lane
// (lane l owns l, l + 32, ...); CH live slots gathered together; NSEG
// ballots of 32 slots cover K <= 32 NSEG. The logit of slot k is (q . K[j]
// + d_k . (Wk[:3] q, We q)) / sqrt(C): the four sums over q are taken once
// an item, reduced with its first chunk's dot products, after those
// gathers are issued, so that q and those rows are fetched together; all
// of a chunk's sums are reduced over the warp at once. One item at a time:
// two a warp spilled at 72 registers and lost (PERF.md).
template <int CPL, int CH, int NSEG>
__device__ __forceinline__ void ea_items(const Attn& A, const EaBlock& B, int s, int sa,
                                         int row0, int w, int nw, int lane,
                                         float (&wv)[3][CPL], int& gate) {
  const int C = A.C, GC = A.G * C, K = A.K, Cp = B.L.Cp, GB = B.L.GB;
  const float* s_wq = reinterpret_cast<const float*>(B.sm + B.L.wq);
  const float inv_sqrt_c = 1.f / sqrtf((float)C);
  constexpr int NR = pow2_at_least(CH + 4);        // sums reduced together
  for (int it = w; EA_GATHER && it < EA_R * B.ng; it += nw) {
    const int r = it / B.ng, gl = it % B.ng, g = B.g0 + gl, row = row0 + r;
    if (g != gate) {
      gate = g;
#pragma unroll
      for (int u = 0; u < CPL; ++u) {
        const int c = lane + 32 * u, col = g * C + c;
#pragma unroll
        for (int d = 0; d < 3; ++d) wv[d][u] = c < C ? A.wv[(size_t)d * GC + col] : 0.f;
      }
    }
    const int* sj = reinterpret_cast<const int*>(B.sm + B.L.tj) + (s * EA_R + r) * K;
    const float4* sd = reinterpret_cast<const float4*>(B.sm + B.L.td) + (s * EA_R + r) * K;
    float qv[CPL], a[CPL], qw[4];
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
      const int c = lane + 32 * u;
      qv[u] = row < A.Nd && c < C ? A.q[(size_t)row * GC + g * C + c] : 0.f;
      a[u] = 0.f;
    }
    bool have_qw = false;

    // online softmax over chunks of CH live slots, in ascending slot order:
    // slots s0 .. s0 + 31 of each ballot, the state carried across ballots
    float mx = NEG, den = 0.f, sl = 0.f;
    for (int s0 = 0; s0 < 32 * NSEG; s0 += 32) {
      unsigned rem = __ballot_sync(FULL, s0 + lane < K && sj[s0 + lane] >= 0);
      while (rem) {                       // the same for the whole warp
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
        // each slot's q . K[j] and, on the first chunk, q's four sums with
        // Wk[:3] and We, reduced over the warp together
        float red[NR];
#pragma unroll
        for (int v = 0; v < NR; ++v) red[v] = 0.f;
#pragma unroll
        for (int c = 0; c < CH; ++c)
#pragma unroll
          for (int u = 0; u < CPL; ++u) red[c] += qv[u] * kv[c][u];
        if (!have_qw) {
#pragma unroll
          for (int u = 0; u < CPL; ++u) {
            const int c = lane + 32 * u;
            if (c >= Cp) continue;
#pragma unroll
            for (int d = 0; d < 4; ++d) red[CH + d] += qv[u] * s_wq[(d * GB + gl) * Cp + c];
          }
        }
        warp_sums<NR>(red);
        if (!have_qw) {
          have_qw = true;
#pragma unroll
          for (int d = 0; d < 4; ++d) qw[d] = red[CH + d];
        }
        float lg[CH], ln[CH], cm = NEG;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const float4 d = sd[ks[c]];
#pragma unroll
          for (int u = 0; u < CPL; ++u)
            vv[c][u] = fmaxf(vv[c][u] + d.x * wv[0][u] + d.y * wv[1][u] + d.z * wv[2][u], 0.f);
          lg[c] = on[c] ? (red[c] + d.x * qw[0] + d.y * qw[1] + d.z * qw[2] + d.w * qw[3]) *
                              inv_sqrt_c
                        : NEG;
          ln[c] = d.w;
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
          sl += e * ln[c];
#pragma unroll
          for (int u = 0; u < CPL; ++u) a[u] += e * vv[c][u];
        }
        mx = mnew;
      }
    }

    // the item's sum alpha relu(pre_v) (zero past C, and on a row with no
    // live slot, whose output is its skip), sum alpha len and sum alpha
    float* ar = reinterpret_cast<float*>(B.sm + B.L.a) + (sa * EA_R + r) * B.L.AS + gl * Cp;
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
      const int c = lane + 32 * u;
      if (c < Cp) ar[c] = den > 0.f ? a[u] / den : 0.f;
    }
    if (lane == 0) {
      float* ls = reinterpret_cast<float*>(B.sm + B.L.ls) + ((sa * EA_R + r) * GB + gl) * 2;
      ls[0] = den > 0.f ? sl / den : 0.f;
      ls[1] = den > 0.f ? 1.f : 0.f;
    }
  }
}

// Gather worker w of nw on tile i of the block: its items (ea_items).
template <int CPL, int CH, int NSEG>
__device__ __forceinline__ void ea_gather(const Attn& A, const EaBlock& B, int i, int w,
                                          int nw, int lane, float (&wv)[3][CPL], int& gate) {
  const int s = i % EA_ST, sa = i % EA_SA;
  mbar_wait(&B.bar[EA_TFULL + s], (i / EA_ST) & 1);
  if (i >= EA_SA) mbar_wait(&B.bar[EA_AEMPTY + sa], (i / EA_SA - 1) & 1);
  const int row0 = (B.tf + i * B.ts) * EA_R;
  ea_items<CPL, CH, NSEG>(A, B, s, sa, row0, w, nw, lane, wv, gate);
  EA_STAMP(5, w == 0 && i == 0);
  if (w < EA_GW) warp_arrive(&B.bar[EA_TEMPTY + s], lane);
  warp_arrive(&B.bar[EA_AFULL + sa], lane);
}

// NT n8 column tiles n0, n0 + 1, ... of gate gl (of the block's) for a
// stage's 16 rows: the rows times Wl2[g] on mma.sync m16n8k8 in 3xTF32
// (each A and B fragment split into TF32 hi and lo as it is loaded; a
// k-step's B fragments first, then its products in three waves of NT
// independent ones: each mma_tf32 is its own asm statement, issued in
// program order), then out = product + bl2 sum alpha + We sum alpha len +
// skip, straight from the accumulators (two adjacent columns a lane, 32
// contiguous bytes of a row from each group of 4 lanes).
template <int CPL, int NT>
__device__ __forceinline__ void ea_unit(const Attn& A, const EaBlock& B, const float* at,
                                        const float* ls, int row0, int gl, int n0,
                                        int lane, bool vec) {
  const int C = A.C, GC = A.G * C, Cp = B.L.Cp, KS = Cp / 8, GB = B.L.GB, AS = B.L.AS;
  const int gr = lane >> 2, tq = lane & 3, g = B.g0 + gl;
  const float2* wb0 = reinterpret_cast<const float2*>(B.sm + B.L.wl2) +
                      (gl * KS * KS + n0) * 32 + lane;
  float acc[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[t][v] = 0.f;
#pragma unroll
  for (int ks = 0; ks < 4 * CPL; ++ks) {          // Cp <= 32 CPL
    if (!EA_PRODUCT || ks >= KS) break;
    const float* ar = at + gr * AS + gl * Cp + ks * 8 + tq;
    uint32_t ah[4], al[4], bh[NT][2], bl[NT][2];
    split_tf32_finite(ar[0], ah[0], al[0]);
    split_tf32_finite(ar[8 * AS], ah[1], al[1]);
    split_tf32_finite(ar[4], ah[2], al[2]);
    split_tf32_finite(ar[8 * AS + 4], ah[3], al[3]);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const float2 b = wb0[(ks * KS + t) * 32];
      split_tf32_finite(b.x, bh[t][0], bl[t][0]);
      split_tf32_finite(b.y, bh[t][1], bl[t][1]);
    }
#pragma unroll
    for (int t = 0; t < NT; ++t) mma_tf32(acc[t], al, bh[t]);
#pragma unroll
    for (int t = 0; t < NT; ++t) mma_tf32(acc[t], ah, bl[t]);
#pragma unroll
    for (int t = 0; t < NT; ++t) mma_tf32(acc[t], ah, bh[t]);
  }
  const float* b2 = A.bl2 + g * C;
  const float* e2 = A.we + g * C;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = gr + 8 * h, row = row0 + r;
    if (row >= A.Nd) continue;
    const float sl = ls[(r * GB + gl) * 2], sum = ls[(r * GB + gl) * 2 + 1];
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int c = (n0 + t) * 8 + 2 * tq;
      const size_t o = (size_t)row * GC + g * C + c;
      const float v0 = acc[t][2 * h], v1 = acc[t][2 * h + 1];
      if (!EA_GATHER) {                   // keep the products
        if (v0 == 12345.f) A.out[o] = v1;
      } else if (vec && c + 2 <= C) {
        const float2 s2 = *reinterpret_cast<const float2*>(A.sk + o);
        const float2 bb = *reinterpret_cast<const float2*>(b2 + c);
        const float2 ee = *reinterpret_cast<const float2*>(e2 + c);
        *reinterpret_cast<float2*>(A.out + o) =
            make_float2(v0 + bb.x * sum + ee.x * sl + s2.x,
                        v1 + bb.y * sum + ee.y * sl + s2.y);
      } else {
        if (c < C) A.out[o] = v0 + b2[c] * sum + e2[c] * sl + A.sk[o];
        if (c + 1 < C) A.out[o + 1] = v1 + b2[c + 1] * sum + e2[c + 1] * sl + A.sk[o + 1];
      }
    }
  }
}

// Product worker p of np's units of NT n8 column tiles of one gate, units
// p, p + np, ... (a gate's last unit may be narrower: it goes a tile at a
// time).
template <int CPL, int NT>
__device__ __forceinline__ void ea_units(const Attn& A, const EaBlock& B, const float* at,
                                         const float* ls, int row0, int p, int np, int lane,
                                         bool vec) {
  const int KS = B.L.Cp / 8, nch = (KS + NT - 1) / NT;
  for (int u = p; u < B.ng * nch; u += np) {
    const int gl = u / nch, n0 = (u % nch) * NT;
    if (n0 + NT <= KS) {
      ea_unit<CPL, NT>(A, B, at, ls, row0, gl, n0, lane, vec);
    } else {
      for (int n = n0; n < KS; ++n) ea_unit<CPL, 1>(A, B, at, ls, row0, gl, n, lane, vec);
    }
  }
}

// Product worker p of np on tile i of the block: once its sums (and, the
// first time, the block's gates of Wl2) are in, its units (ea_units), as
// narrow as leave no worker with two (a small conv's few gates), else
// EA_NTW n8 tiles wide.
template <int CPL>
__device__ __forceinline__ void ea_product(const Attn& A, const EaBlock& B, int i, int p,
                                           int np, int lane) {
  const int C = A.C, KS = B.L.Cp / 8, GB = B.L.GB, AS = B.L.AS, sa = i % EA_SA;
  const bool vec = C % 2 == 0 &&
      ((reinterpret_cast<uintptr_t>(A.out) | reinterpret_cast<uintptr_t>(A.sk) |
        reinterpret_cast<uintptr_t>(A.bl2) | reinterpret_cast<uintptr_t>(A.we)) & 7) == 0;
  if (i == 0) {
    mbar_wait(&B.bar[EA_WREADY], 0);
    EA_STAMP(2, p == EA_GW % np);
  }
  mbar_wait(&B.bar[EA_AFULL + sa], (i / EA_SA) & 1);
  EA_STAMP(3, p == EA_GW % np && i == 0);
  const int row0 = (B.tf + i * B.ts) * EA_R;
  const float* at = reinterpret_cast<const float*>(B.sm + B.L.a) + sa * EA_R * AS;
  const float* ls = reinterpret_cast<const float*>(B.sm + B.L.ls) + sa * EA_R * GB * 2;
  if (B.ng * KS <= np)
    ea_units<CPL, 1>(A, B, at, ls, row0, p, np, lane, vec);
  else if (B.ng * ((KS + 1) / 2) <= np)
    ea_units<CPL, 2>(A, B, at, ls, row0, p, np, lane, vec);
  else if (B.ng * ((KS + 3) / 4) <= np)
    ea_units<CPL, 4>(A, B, at, ls, row0, p, np, lane, vec);
  else
    ea_units<CPL, EA_NTW>(A, B, at, ls, row0, p, np, lane, vec);
  EA_STAMP(4, p == EA_GW % np && i == 0);
  EA_STAMP(6, p == EA_GW % np && i == B.nt - 1);
  warp_arrive(&B.bar[EA_AEMPTY + sa], lane);
}

// Persistent blocks of EA_GW gather warps, EA_PW product warps and EA_TW
// table warps (csrc note above); the grid and gate groups as EaGrid says.
template <int CPL, int CH, int NSEG>
__global__ void __launch_bounds__(EA_THREADS, 1) edge_attn(Attn A, EaGrid P) {
  extern __shared__ __align__(16) float ea_smem_f[];
  EaBlock B;
  B.sm = reinterpret_cast<unsigned char*>(ea_smem_f);
  B.L = ea_layout(P.GB, A.C, A.K);
  B.bar = reinterpret_cast<uint64_t*>(B.sm + B.L.bar);
  const int grp = blockIdx.x % P.groups, per = gridDim.x / P.groups;
  B.g0 = grp * P.GB;
  B.ng = min(P.GB, A.G - B.g0);
  const int t0 = blockIdx.x / P.groups;
  B.tf = t0;
  B.ts = per;
  B.nt = (P.tiles - t0 + per - 1) / per;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const bool lone = B.nt == 1;
  if (threadIdx.x == 0) {
    for (int s = 0; s < EA_ST; ++s) {
      mbar_init(&B.bar[EA_TFULL + s], EA_TW);
      mbar_init(&B.bar[EA_TEMPTY + s], EA_GW);
    }
    for (int s = 0; s < EA_SA; ++s) {
      mbar_init(&B.bar[EA_AFULL + s], lone ? EA_GW + EA_PW : EA_GW);
      mbar_init(&B.bar[EA_AEMPTY + s], lone ? EA_GW + EA_PW : EA_PW);
    }
    mbar_init(&B.bar[EA_WREADY], 1);
    mbar_fence_init();
    // the block's gates of the Wl2 pack, one bulk copy
    const unsigned bytes = B.ng * B.L.Cp * B.L.Cp * 4;
    mbar_expect_tx(&B.bar[EA_WREADY], bytes);
    bulk_copy_g2s(B.sm + B.L.wl2, A.wl2 + (size_t)B.g0 * B.L.Cp * B.L.Cp, bytes,
                  &B.bar[EA_WREADY]);
    mbar_arrive(&B.bar[EA_WREADY]);
  }
  __syncthreads();
  EA_STAMP(0, threadIdx.x < 32);
  if (warp < EA_GW + EA_PW) {
    // each warp its role, tile after tile; a block of a single tile has
    // every gather and product warp gather, then multiply
    const int nw = lone ? EA_GW + EA_PW : EA_GW, np = lone ? nw : EA_PW;
    if (warp < EA_GW || lone) {
      float wv[3][CPL];                   // Wv[:3] at the lane's columns
      int gate = -1;
      for (int i = 0; i < B.nt; ++i) ea_gather<CPL, CH, NSEG>(A, B, i, warp, nw, lane, wv, gate);
    }
    if (warp >= EA_GW || lone) {
      for (int i = 0; i < B.nt; ++i) ea_product<CPL>(A, B, i, lone ? warp : warp - EA_GW, np, lane);
    }
  } else {
    ea_table(A, B, warp - EA_GW - EA_PW, lane);
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

// edge_attn's grid at these shapes (EaGrid), its blocks and branch. A
// small conv, whose (tile, gate) pairs fill at most EA_SMALL waves of
// blocks, takes one gate a block, so that it spreads over the SMs and
// each block stages one gate of Wl2; a larger one takes the widest gate
// group whose block fits in shared memory (all G at the rollout's widths),
// so that each slot table serves every gate. A block an SM; branch 0 when
// every block has one (tile, gate group), one wave, else 1, persistent.
int ea_plan(const Attn& A, EaGrid* P, int* blocks, int* branch) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int tiles = (A.Nd + EA_R - 1) / EA_R;
  int gb = A.G;
  while (gb > 0 && ea_layout(gb, A.C, A.K).bytes > EA_SMEM_MAX) --gb;
  if (gb == 0) return cudaErrorInvalidValue;
  if (tiles * A.G <= EA_SMALL * sms) gb = 1;
  const int groups = (A.G + gb - 1) / gb, units = tiles * groups;
  *P = {(A.G + groups - 1) / groups, groups, tiles};
  *blocks = units <= sms ? units : sms >= groups ? sms / groups * groups : groups;
  *branch = units <= *blocks ? 0 : 1;
  return 0;
}

template <int CPL, int CH, int NSEG>
int launch_attn(const Attn& A, cudaStream_t s, int* branch) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        edge_attn<CPL, CH, NSEG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        EA_SMEM_MAX);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = true;
  }
  EaGrid P;
  int blocks = 0, taken = -1;
  const int err = ea_plan(A, &P, &blocks, &taken);
  if (err) return err;
  edge_attn<CPL, CH, NSEG><<<blocks, EA_THREADS, ea_layout(P.GB, A.C, A.K).bytes, s>>>(A, P);
  if (branch) *branch = taken;
  return 0;
}

// K = 3: one chunk of 3; K <= 32: chunks of EA_CH under one ballot; else
// two
template <int CPL>
int launch_cpl(const Attn& A, cudaStream_t s, int* branch) {
  if (A.K <= 3) return launch_attn<CPL, 3, 1>(A, s, branch);
  if (A.K <= 32) return launch_attn<CPL, EA_CH, 1>(A, s, branch);
  return launch_attn<CPL, EA_CH, 2>(A, s, branch);
}

// branch, where not null, gets edge_attn's grid: 0 one wave, 1
// persistent, left as it is when there are no rows
int launch_edge_attn(const Attn& A, cudaStream_t s, int* branch) {
  if (A.Nd <= 0) return 0;
  if ((reinterpret_cast<uintptr_t>(A.wl2) & 15) != 0) return cudaErrorMisalignedAddress;
  switch ((A.C + 31) / 32) {
    case 1: return launch_cpl<1>(A, s, branch);
    case 2: return launch_cpl<2>(A, s, branch);
    case 3: return launch_cpl<3>(A, s, branch);
    case 4: return launch_cpl<4>(A, s, branch);
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
// (kernels/edge_stage.py pack_tf32x3, 16-byte aligned); wl2: Wl2 in B
// fragment order (pack_l2, 16-byte aligned); the biases, wk and wv (their
// position rows), bl2 [G, C] and we [GC] in the JAX package's layout.
// branch and attn_branch, where not null, get
// node_proj's and edge_attn's grids: 0 one wave, 1 persistent, -1 no
// launch.
int edge_stage_forward(
    const float* x_src, int Ns, int Fs, const float* x_dst, int Nd, int Fd,
    const int* nbr, const float* elen, const float* nmask, int K,
    const uint32_t* wpack, const float* bq, const float* bk, const float* bv,
    const float* bsk, const float* wk, const float* wv, const float* wl2,
    const float* bl2, const float* we, int G, int C, float* kn, float* vn,
    float* q, float* sk, float* out, void* stream, int* branch,
    int* attn_branch) {
  if (!takes(Fs, Fd, G, C, K)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();   // clear any stale error
  int err = launch_node_proj(x_src, Ns, Fs, x_dst, Nd, Fd, wpack, bq, bk, bv,
                             bsk, G * C, kn, vn, q, sk, s, branch);
  if (err) return err;
  if (attn_branch) *attn_branch = -1;
  err = launch_edge_attn({x_src, Ns, Fs, x_dst, Nd, Fd, nbr, elen, nmask, K, kn,
                          vn, q, sk, wk, wv, wl2, bl2, we, G, C, out}, s,
                         attn_branch);
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

// The edge kernel alone (one edge_attn launch) on given projections, wl2
// as above; branch as attn_branch above.
int edge_attn_forward(
    const float* x_src, int Ns, int Fs, const float* x_dst, int Nd, int Fd,
    const int* nbr, const float* elen, const float* nmask, int K,
    const float* kn, const float* vn, const float* q, const float* sk,
    const float* wk, const float* wv, const float* wl2, const float* bl2,
    const float* we, int G, int C, float* out, void* stream, int* branch) {
  if (branch) *branch = -1;
  if (!takes(Fs, Fd, G, C, K)) return cudaErrorInvalidValue;
  cudaGetLastError();
  const int err = launch_edge_attn(
      {x_src, Ns, Fs, x_dst, Nd, Fd, nbr, elen, nmask, K, kn, vn, q, sk, wk,
       wv, wl2, bl2, we, G, C, out},
      static_cast<cudaStream_t>(stream), branch);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
