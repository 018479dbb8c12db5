// Fused periodic graph-transformer conv (PeriodConv) at bf16 operands with
// fp32 accumulation, for Hopper.
//
// Replaces the bf16 instantiation (compute_dtype=bfloat16, the default) of
// the TPU kernels graingraphnn_tpu/kernels/edge_stage.py::_kernel (K < 8:
// push and connect, K = 3) and ::_kernel_flat (K >= 8: pull, K = 16 on the
// device rollout), both launched by apply_period_conv_pallas, which JAX's
// pallas=True rollout runs. The function is the TPU kernel's, rounding
// exactly its values to bf16 (to nearest, ties to even), everything else
// fp32:
//   1. the inputs x_src and x_dst, every lane;
//   2. Wq, Wk, Wv, Wskip and Wl2 (the biases and We stay fp32);
//   3. the relocated positions xjp = bf16(bf16(x_j) - bf16(x_i) + wrap) on
//      lanes 0..2 (the other lanes are bf16(x_j));
//   4. each product q * k_e, before the per-gate sum over C;
//   5. relu(pre_v), before the l2 product;
//   6. alpha = exp(l - max) / denom, after the division.
// With xjp Wk = bf16(x_j[3:]) bf16(Wk[3:]) + xjp[:3] bf16(Wk[:3]) (and the
// same for Wv) the F-wide products run once per NODE, as in the fp32
// kernels (csrc/edge_stage.cu), and the edge kernel adds a rank-3 term per
// edge in fp32. Two kernels per conv.
//
// The weights come pre-packed (kernels/edge_stage.py pack_bf16, built once
// per weight version, so no kernel converts a weight): one int32 buffer
// holding first the four projections (Wk and Wv with rows 0..2 zeroed, Wq,
// Wskip; G*C padded to 128 columns, depth the wider F padded to 16) as
// wgmma's K-major B operand without swizzle, per 128-column slice and k16
// step 4096 contiguous bytes of 8 x 8 core matrices (csrc/wgmma_bf16.cuh),
// then Wl2 [G][Cp][Cp / 2 + 4] words (Cp = C padded to 16), column n of
// Wl2[g] as its k pairs, as mma.sync m16n8k16 takes B fragments, 4 words
// of padding keeping them conflict-free. Zero past each weight.
//
// node_proj_bf16: the four node projections as ONE grouped launch, x_src
//   through Wk and Wv (lanes 0..2 masked: their rows of the pack are zero
//   as well), x_dst through Wq and Wskip. Bound: bytes, the [N, 2 GC] fp32
//   outputs; at the rollout's sizes also the latency of a block's copies,
//   fragments and stores, all blocks in one wave. Design: a block is one
//   warpgroup on a 64 x 128 tile of one product; its W slice (28 KB) and
//   bias slice arrive by one bulk copy each (cp.async.bulk on an
//   mbarrier), and x by bulk copies of whole row tiles: 64 rows are one
//   contiguous, 16-byte aligned run of 64 F fp32 values whatever F (a
//   grain row of 107 values is 428 bytes, so rows themselves are not
//   aligned; the tile is), the ragged last tile's 0-3 trailing values
//   copied by the issuing thread. Each thread rounds its A fragments of
//   every k-step to bf16 straight from the fp32 tile into registers, and
//   the product runs as wgmma m64n128k16 with B from the resident slice,
//   so shared memory carries B once per warpgroup and A once (mma.sync on
//   8 warps read 3.8x the bytes and was bound by them). While the grid
//   fits one wave at a tile a block (three blocks an SM: 300-396 tiles at
//   120 um) a block takes one tile on one stage; past that, T tiles
//   through two stages, tile t + 1's copy in flight during tile t's
//   product and stores. The epilogue adds the bias and stores straight
//   from the accumulators, 16 bytes a thread after one exchange of lane
//   pairs.
//
// edge_attn_bf16: the gathers, the softmax and the value MLP's second
//   layer, a warp per destination row over its live slots (ballots of 32
//   slots, up to 8 live slots gathered together, as edge_attn); a block of
//   32 rows and one gate. Bound: bytes, as edge_attn; in fact one block's
//   critical path, since each conv is one wave: dependent loads (slot
//   table, then positions and gathers), then the rows' arithmetic, which
//   is issue-bound because every warp of an SM runs the same phase.
//   Alpha is rounded after the division, so the softmax needs the row's
//   final max and denominator before any value is weighted. The design:
//   Wl2[g] arrives by one bulk copy issued at block start and waited for
//   only before the l2 product; the skip rows, bl2 and We by cp.async at
//   block start, waited for before the epilogue; each warp builds its own
//   rows' slot tables (both rows' loads in flight together) and goes on
//   without a block barrier; the V rows of a row's first chunk of live
//   slots (all of them at K = 3, up to 8 at pull) are gathered with the K
//   rows and bf16(relu(V[j] + xjp Wv[:3])) kept in registers until alpha
//   is known, so such a row waits for one gather, not two (later chunks
//   gather V again: staging a row's second chunk of V rows in shared
//   memory by cp.async, and q by cp.async at block start, each measured
//   slower, by up to 10 % and 5 %; PERF.md). The logit of slot s is the
//   sum of the bf16-rounded products q * (K[j] + xjp Wk[:3] + len We),
//   lane s of the warp keeping it; a chunk's logits are reduced together (chunk_sum: one transpose
//   reduction of 6 or 10 shuffles, not a 5-shuffle butterfly per slot),
//   the row's max and denominator over the lanes that can hold a slot.
//   The l2 product is linear, so it runs once per destination ROW on the
//   fp32 sum:
//     sum_k alpha_k (bf16(relu_k) Wl2 + bl2 + len_k We)
//       = (sum_k alpha_k bf16(relu_k)) Wl2 + bl2 sum alpha + We sum alpha len
//   To keep that product exact to fp32 order against the bf16 Wl2, the row
//   sum is split into three bf16 parts (hi + mid + lo carry 24 bits) and
//   multiplied on mma.sync m16n8k16 bf16, each part and column tile its own
//   chain of fp32 accumulation, summed hi + (mid + lo) at the end. A
//   warp's two rows run one after the other: holding both rows' gathers
//   would cost 18 more registers a lane at K = 3, past the 64 that two
//   blocks of 512 threads an SM allow (smaller blocks, 16 rows, were
//   faster only at 40 um: scripts/bf16_phase_trace.py).
//
// TRACE_STAMP(k, i, on) and TRACE_END(k, i) mark phase boundaries (kernel
// k, point i): scripts/bf16_phase_trace.py builds a copy of this source
// with them defined to record the time on thread 0 of each block; in the
// kernels' own build they are empty.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_async.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"     // cp_async16, cp_async_wait_all
#include "wgmma_bf16.cuh"

#ifndef TRACE_STAMP
#define TRACE_STAMP(k, i, on)
#define TRACE_END(k, i)
#endif

namespace {

constexpr int MAX_F = 128;      // node feature width the kernels take
constexpr int MAX_C = 128;      // gate width edge_attn_bf16 takes
constexpr int MAX_G = 8;
constexpr int MAX_K = 64;       // neighbor slots per row: two ballots of 32
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;

// node_proj_bf16 tiling: a block is one warpgroup, a 64 x 128 tile on
// wgmma m64n128k16 (csrc/wgmma_bf16.cuh)
constexpr int NB_BM = 64;                 // rows of a tile
constexpr int NB_BN = 128;                // columns of a block's slice
constexpr int NB_THREADS = 128;
constexpr int NB_MAX_STAGES = 2;
constexpr int NB_KSTEP_BYTES = NB_BN * 16 * 2;   // a k16 step of a W slice

// edge_attn_bf16 tiling: EB_R destination rows per block, EB_WARPS warps
// (other tilings build with -DEB_ROWS=16 -DEB_BLOCK_WARPS=8 and the like)
#ifndef EB_ROWS
#define EB_ROWS 32
#endif
#ifndef EB_BLOCK_WARPS
#define EB_BLOCK_WARPS 16
#endif
constexpr int EB_R = EB_ROWS;
constexpr int EB_WARPS = EB_BLOCK_WARPS;
constexpr int EB_THREADS = EB_WARPS * 32;
constexpr int EB_RPW = EB_R / EB_WARPS;                   // rows a warp
constexpr int EB_MT = EB_R / 16;                          // m16 tiles
constexpr int EB_WPM = EB_WARPS / EB_MT;                  // warps per m16 tile
constexpr int EB_NT = (MAX_C / 8 + EB_WPM - 1) / EB_WPM;  // n8 tiles per warp

__host__ __device__ inline int pad16(int v) { return (v + 15) & ~15; }

// the pack's layout (kernels/edge_stage.py builds it): the projections'
// depth (the wider F padded to 16), their column count, where Wl2 starts
__host__ __device__ inline int np_fp(int Fs, int Fd) { return pad16(Fs > Fd ? Fs : Fd); }
__host__ __device__ inline int np_gcp(int GC) {
  return (GC + NB_BN - 1) / NB_BN * NB_BN;
}
__host__ __device__ inline size_t l2_offset(int Fs, int Fd, int GC) {
  return (size_t)4 * np_gcp(GC) * np_fp(Fs, Fd) / 2;
}

// Shared memory of a node_proj_bf16 block: its W slice (depth / 16 k-steps
// of NB_KSTEP_BYTES), its bias slice [NB_BN], S x stages of NB_BM rows at
// the wider F (padded to 16), 1 + S mbarriers (the slices, then each stage).
__host__ __device__ inline int np_stage_floats(int Fs, int Fd) {
  return NB_BM * np_fp(Fs, Fd);
}
__host__ __device__ inline int np_smem(int Fs, int Fd, int S) {
  return np_fp(Fs, Fd) / 16 * NB_KSTEP_BYTES +
         (NB_BN + S * np_stage_floats(Fs, Fd)) * 4 + (1 + S) * 8;
}

struct ProjSet {        // y_p [N, GC] = x [N, F] w_p [F, GC] + b_p, p = k, v, q, sk
  const float* x[2];    // x_src (k, v), x_dst (q, sk)
  int N[2], F[2];
  const uint32_t* w;    // the pack's projections
  const float* b[4];
  float* y[4];
  int GC, T, S;         // gate width G*C, tiles a block, x stages
  int blocks[4];        // blocks of each product
};

// n floats from src to dst by the copy engine on bar, 16-byte blocks of
// them, and the 0-3 after those here; the arrival comes last, so the
// phase completes when both have landed.
__device__ __forceinline__ void copy_floats(float* dst, const float* src, int n,
                                            uint64_t* bar) {
  const int bulk = n & ~3;
  mbar_expect_tx(bar, bulk * 4);
  if (bulk > 0) bulk_copy_g2s(dst, src, bulk * 4, bar);
  for (int u = bulk; u < n; ++u) dst[u] = src[u];
  mbar_arrive(bar);
}

// A 128-column slice of one of the grouped products over T consecutive
// row tiles of 64; lanes below f0 of x (3 for x_src) and at or past F
// count as zeros.
__global__ void __launch_bounds__(NB_THREADS, 3) node_proj_bf16(ProjSet P) {
  extern __shared__ __align__(128) uint32_t nb_smem[];
  TRACE_STAMP(0, 0, true);
  int bi = blockIdx.x, p = 0;
  while (p < 3 && bi >= P.blocks[p]) bi -= P.blocks[p++];
  const int GC = P.GC, slices = np_gcp(GC) / NB_BN;
  const int s = bi % slices, t0 = (bi / slices) * P.T;
  const int xi = p >> 1, N = P.N[xi], F = P.F[xi], f0 = xi == 0 ? 3 : 0;
  const float* x = P.x[xi];
  const int nt = min(P.T, (N + NB_BM - 1) / NB_BM - t0), S = P.S;
  const int Fw = np_fp(P.F[0], P.F[1]), stage = np_stage_floats(P.F[0], P.F[1]);
  const int col0 = s * NB_BN, ncols = min(NB_BN, GC - col0);
  unsigned char* ws = reinterpret_cast<unsigned char*>(nb_smem);   // W slice
  float* sb = reinterpret_cast<float*>(ws + Fw / 16 * NB_KSTEP_BYTES);  // bias
  float* xs = sb + NB_BN;                                  // [S][NB_BM][F]
  uint64_t* bar = reinterpret_cast<uint64_t*>(xs + S * stage);  // [1 + S]
  const int tid = threadIdx.x;

  // tile t's rows, one contiguous run of floats, into stage st
  auto issue = [&](int st, int t) {
    copy_floats(xs + st * stage, x + (size_t)t * NB_BM * F,
                min(NB_BM, N - t * NB_BM) * F, &bar[1 + st]);
  };
  if (tid == 0) {
    for (int i = 0; i <= S; ++i) mbar_init(&bar[i], 1);
    mbar_fence_init();
    for (int st = 0; st < S && st < nt; ++st) issue(st, t0 + st);
    const unsigned wbytes = Fw / 16 * NB_KSTEP_BYTES;
    mbar_expect_tx(&bar[0], wbytes);
    bulk_copy_g2s(ws, P.w + (size_t)(p * slices + s) * (wbytes / 4), wbytes,
                  &bar[0]);
    copy_floats(sb, P.b[p] + col0, ncols, &bar[0]);
  }

  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tq = lane & 3, r = warp * 16 + g;   // rows r, r + 8
  const int KS = pad16(F) / 16;                                 // k-steps
  float* y = P.y[p];
  const bool yvec = GC % 4 == 0 && (reinterpret_cast<uintptr_t>(y) & 15) == 0;
  __syncthreads();                        // the mbarriers are initialised
  TRACE_STAMP(0, 1, true);

  for (int it = 0; it < nt; ++it) {
    const int st = it % S, row0 = (t0 + it) * NB_BM;
    mbar_wait(&bar[1 + st], (it / S) & 1);
    TRACE_STAMP(0, 2, it == 0);
    // this thread's A fragments of every k-step, x rounded to bf16 (zeros
    // outside [f0, F); rows past the tile's end are never stored)
    const float* xt = xs + st * stage;
    auto pair = [&](int row, int k) {
      const float* v = xt + row * F;
      return pack_bf16(k >= f0 && k < F ? v[k] : 0.f,
                       k + 1 >= f0 && k + 1 < F ? v[k + 1] : 0.f);
    };
    uint32_t a[MAX_F / 16][4];
#pragma unroll
    for (int ks = 0; ks < MAX_F / 16; ++ks) {
      const int k = ks * 16 + 2 * tq;
      a[ks][0] = ks < KS ? pair(r, k) : 0u;
      a[ks][1] = ks < KS ? pair(r + 8, k) : 0u;
      a[ks][2] = ks < KS ? pair(r, k + 8) : 0u;
      a[ks][3] = ks < KS ? pair(r + 8, k + 8) : 0u;
    }
    __syncthreads();                      // every warp has read stage st
    TRACE_STAMP(0, 3, it == 0);
    if (tid == 0 && it + S < nt) issue(st, t0 + it + S);
    if (it == 0) mbar_wait(&bar[0], 0);
    TRACE_STAMP(0, 4, it == 0);

    float acc[64];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < MAX_F / 16; ++ks)
      if (ks < KS)
        wgmma_m64n128k16(acc, a[ks], wgmma_desc(ws + ks * NB_KSTEP_BYTES, 128, 256),
                         ks > 0);
    wgmma_commit();
    wgmma_wait0();

    // the bias, then rows out: a lane pair swaps halves so each lane holds
    // 4 consecutive columns of one row (16-byte stores)
    const int ra = row0 + r;
#pragma unroll
    for (int ni = 0; ni < NB_BN / 8; ++ni) {
      const int n = ni * 8 + 2 * tq, c = col0 + n;
      const float b0 = n < ncols ? sb[n] : 0.f, b1 = n + 1 < ncols ? sb[n + 1] : 0.f;
      const float* d = acc + 4 * ni;
      const float v0 = d[0] + b0, v1 = d[1] + b1, v2 = d[2] + b0, v3 = d[3] + b1;
      if (yvec) {
        const bool odd = tq & 1;
        const float r0 = __shfl_xor_sync(FULL, odd ? v0 : v2, 1);
        const float r1 = __shfl_xor_sync(FULL, odd ? v1 : v3, 1);
        const int row = odd ? ra + 8 : ra, cc = odd ? c - 2 : c;
        if (row < N && cc < GC)
          *reinterpret_cast<float4*>(y + (size_t)row * GC + cc) =
              odd ? make_float4(r0, r1, v2, v3) : make_float4(v0, v1, r0, r1);
      } else {
        const float v[4] = {v0, v1, v2, v3};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int row = ra + (u >> 1) * 8, cc = c + (u & 1);
          if (row < N && cc < GC) y[(size_t)row * GC + cc] = v[u];
        }
      }
    }
  }
  TRACE_END(0, 5);
}

struct Attn {                             // edge_attn_bf16's inputs and output
  const float* x_src; int Ns, Fs;
  const float* x_dst; int Nd, Fd;
  const int* nbr; const float* elen; const float* nmask; int K;
  const float* kn; const float* vn; const float* q; const float* sk;
  const uint32_t* wl2;                    // the pack's Wl2 [G][Cp][KP2]
  const float* wk; const float* wv; const float* bl2; const float* we;
  int G, C;
  float* out;
};

// Shared memory of an edge_attn_bf16 block at gate width C and K slots:
// Wl2[g] as packed (Cp columns of eb_kp(Cp) words); the tile's rows as
// three bf16 parts (hi, mid, lo) with the same stride (the fp32 product
// goes out through this space); the q and skip rows of the tile and gate
// and bl2[g], We[g], at row stride eb_cq(C); sum alpha len and sum alpha
// per row; the slot table (xjp[:3], len) as float4 and the source row (-1
// where masked); the mbarrier of the Wl2 copy.
__host__ __device__ inline int eb_cp(int C) { return (C + 15) & ~15; }
__host__ __device__ inline int eb_kp(int Cp) { return Cp / 2 + 4; }
__host__ __device__ inline int eb_cq(int C) { return (C + 3) & ~3; }
__host__ __device__ inline int eb_smem(int C, int K) {
  const int Cp = eb_cp(C), KP = eb_kp(Cp), Cq = eb_cq(C);
  return (Cp * KP + 3 * EB_R * KP + EB_R * Cq + 2 * Cq + 2 * EB_R +
          5 * EB_R * K) * (int)sizeof(float) + 8;
}

// The max (MAX) or sum of v over each aligned group of `span` lanes (a
// power of two up to 32), on every lane of the group.
template <bool MAX>
__device__ __forceinline__ float span_reduce(float v, int span) {
  for (int o = 1; o < span; o <<= 1) {
    const float w = __shfl_xor_sync(FULL, v, o);
    v = MAX ? fmaxf(v, w) : v + w;
  }
  return v;
}

// The warp sums of N lane values v[0..N) (N = 4 or 8) by a transpose
// reduction: at the xor distance 16 a lane keeps one half of its values and
// adds its partner's copy of that half, and so on down to one value, then
// plain butterfly steps; lane L ends with the sum of value L >> (5 -
// log2 N). Returns, on the lane of each slot set in `taken` (bit s: slot
// s of the ballot), the sum of that slot's value, slots taking values in
// ascending order.
template <int N>
__device__ __forceinline__ float chunk_sum(float* v, int lane, unsigned taken) {
  constexpr int LOG = N == 8 ? 3 : 2;
  int o = 16;
#pragma unroll
  for (int w = N / 2; w >= 1; w /= 2, o /= 2) {
    const bool up = lane & o;
#pragma unroll
    for (int i = 0; i < w; ++i) {
      const float send = up ? v[i] : v[i + w];
      v[i] = (up ? v[i + w] : v[i]) + __shfl_xor_sync(FULL, send, o);
    }
  }
#pragma unroll
  for (; o > 0; o >>= 1) v[0] += __shfl_xor_sync(FULL, v[0], o);
  const int mine = __popc(taken & ((1u << lane) - 1u));   // my value's index
  return __shfl_sync(FULL, v[0], (mine & (N - 1)) << (5 - LOG));
}

// EB_R destination rows and gate blockIdx.y. CPL = ceil(C / 32) columns
// per lane; CH live slots gathered together; NSEG ballots of 32 slots
// cover K <= 32 * NSEG.
template <int CPL, int CH, int NSEG>
__global__ void __launch_bounds__(EB_THREADS, CH == 3 && CPL <= 3 ? 1024 / EB_THREADS : 1)
    edge_attn_bf16(Attn A) {
  constexpr int CHP = CH <= 4 ? 4 : 8;    // the chunk's sums, padded
  extern __shared__ __align__(128) uint32_t eb_smem_u[];
  const int C = A.C, GC = A.G * C, g = blockIdx.y, K = A.K;
  const int Cp = eb_cp(C), KP = eb_kp(Cp), OS = Cp + 4, Cq = eb_cq(C);
  TRACE_STAMP(1, 0, true);
  uint32_t* ws = eb_smem_u;                            // [Cp][KP] Wl2[g]^T
  uint32_t* ps = ws + Cp * KP;                         // [3][EB_R][KP] row parts
  uint16_t* ph = reinterpret_cast<uint16_t*>(ps);      // the same, as bf16
  float* os = reinterpret_cast<float*>(ps);            // [EB_R][OS] the product
  float* s_sk = reinterpret_cast<float*>(ps + 3 * EB_R * KP);   // [EB_R][Cq]
  float* s_b2 = s_sk + EB_R * Cq;                               // [Cq]
  float* s_we = s_b2 + Cq;                                      // [Cq]
  float* s_len = s_we + Cq;                                     // [EB_R]
  float* s_sum = s_len + EB_R;                                  // [EB_R]
  float4* s_d = reinterpret_cast<float4*>(s_sum + EB_R);        // [EB_R * K]
  int* s_j = reinterpret_cast<int*>(s_d + EB_R * K);            // [EB_R * K]
  uint64_t* bar = reinterpret_cast<uint64_t*>(s_j + EB_R * K);
  const int row0 = blockIdx.x * EB_R, nrows = min(EB_R, A.Nd - row0);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  int span = 1;
  while (span < K && span < 32) span <<= 1;

  // Wl2[g], packed: one bulk copy, waited for before the l2 product
  if (tid == 0) {
    const unsigned bytes = Cp * KP * 4;
    mbar_init(bar, 1);
    mbar_fence_init();
    mbar_expect_tx(bar, bytes);
    bulk_copy_g2s(ws, A.wl2 + (size_t)g * Cp * KP, bytes, bar);
    mbar_arrive(bar);
  }

  // the tile's skip rows, bl2[g] and We[g], by 16-byte asynchronous
  // copies where aligned (waited for before the epilogue), else loaded here
  const bool vec = C % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(A.out) | reinterpret_cast<uintptr_t>(A.sk) |
        reinterpret_cast<uintptr_t>(A.bl2) | reinterpret_cast<uintptr_t>(A.we)) & 15) == 0;
  const size_t gc0 = (size_t)row0 * GC + g * C;
  if (vec) {
    const int c4 = C / 4;
    for (int i = tid; i < nrows * c4; i += EB_THREADS) {
      const int r = i / c4, c = (i % c4) * 4;
      cp_async16(s_sk + r * Cq + c, A.sk + gc0 + (size_t)r * GC + c);
    }
    for (int i = tid; i < c4; i += EB_THREADS) {
      cp_async16(s_b2 + 4 * i, A.bl2 + g * C + 4 * i);
      cp_async16(s_we + 4 * i, A.we + g * C + 4 * i);
    }
  } else {
    for (int i = tid; i < nrows * C; i += EB_THREADS) {
      const int r = i / C, c = i % C;
      s_sk[r * Cq + c] = A.sk[gc0 + (size_t)r * GC + c];
    }
    for (int c = tid; c < C; c += EB_THREADS) {
      s_b2[c] = A.bl2[g * C + c];
      s_we[c] = A.we[g * C + c];
    }
  }

  // Wk[:3], Wv[:3] (bf16) and We (fp32) at this lane's gate columns
  // c = lane + 32 u
  float wk0[CPL], wk1[CPL], wk2[CPL], wv0[CPL], wv1[CPL], wv2[CPL], we[CPL];
#pragma unroll
  for (int u = 0; u < CPL; ++u) {
    const int c = lane + 32 * u, col = g * C + c;
    const bool ok = c < C;
    wk0[u] = ok ? bf16_round(A.wk[col]) : 0.f;
    wk1[u] = ok ? bf16_round(A.wk[GC + col]) : 0.f;
    wk2[u] = ok ? bf16_round(A.wk[2 * GC + col]) : 0.f;
    wv0[u] = ok ? bf16_round(A.wv[col]) : 0.f;
    wv1[u] = ok ? bf16_round(A.wv[GC + col]) : 0.f;
    wv2[u] = ok ? bf16_round(A.wv[2 * GC + col]) : 0.f;
    we[u] = ok ? A.we[col] : 0.f;
  }

  // this warp's rows' slot tables, lane s taking slot s0 + s of each (all
  // the rows' loads in flight together): the source row of a live slot
  // (-1 where masked) and (xjp[:3], len), xjp = bf16(bf16(x_j) - bf16(x_i)
  // + wrap). No block barrier: a warp goes on to its rows when its own
  // tables are written.
  {
    int jv[EB_RPW][NSEG];
    float lv[EB_RPW][NSEG];
    bool on[EB_RPW][NSEG];
#pragma unroll
    for (int q = 0; q < EB_RPW; ++q)
#pragma unroll
      for (int sg = 0; sg < NSEG; ++sg) {
        const int i = row0 + warp + EB_WARPS * q, e = 32 * sg + lane;
        const bool ok = i < A.Nd && e < K;
        const size_t at = (size_t)i * K + e;
        on[q][sg] = ok && A.nmask[at] > 0.f;
        lv[q][sg] = ok ? A.elen[at] : 0.f;
        jv[q][sg] = ok ? A.nbr[at] : 0;
      }
#pragma unroll
    for (int q = 0; q < EB_RPW; ++q) {
      const int r = warp + EB_WARPS * q, i = row0 + r;
      float xi[3];
#pragma unroll
      for (int c = 0; c < 3; ++c)
        xi[c] = i < A.Nd ? bf16_round(A.x_dst[(size_t)i * A.Fd + c]) : 0.f;
#pragma unroll
      for (int sg = 0; sg < NSEG; ++sg) {
        const int e = 32 * sg + lane;
        int j = -1;
        float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
        if (on[q][sg]) {
          const int jj = jv[q][sg];
          j = jj < 0 || jj >= A.Ns ? 0 : jj;
          float p[3];
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            const float rel = bf16_round(A.x_src[(size_t)j * A.Fs + c]) - xi[c];
            p[c] = bf16_round(rel + ((rel < -0.5f ? 1.f : 0.f) - (rel > 0.5f ? 1.f : 0.f)));
          }
          d = make_float4(p[0], p[1], p[2], lv[q][sg]);
        }
        if (e < K) {
          s_j[r * K + e] = j;
          s_d[r * K + e] = d;
        }
      }
    }
  }
  const float inv_sqrt_c = 1.f / sqrtf((float)C);
  TRACE_STAMP(1, 1, true);
  __syncwarp();
  TRACE_STAMP(1, 2, true);

  // a warp per destination row, over its live slots only
  for (int r = warp; r < EB_R; r += EB_WARPS) {
    const int i = row0 + r;
    const int* sj = s_j + r * K;
    const float4* sd = s_d + r * K;
    float qv[CPL], a[CPL];
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
      const int c = lane + 32 * u;
      qv[u] = i < A.Nd && c < C ? A.q[(size_t)i * GC + g * C + c] : 0.f;
      a[u] = 0.f;
    }
    TRACE_STAMP(1, 10, r == 0);

    // pass 1: the logit of each live slot, in ascending slot order, CH
    // slots at a time; lane s keeps the logit of slot s0 + s of ballot s0.
    // The first chunk's V rows are gathered with its K rows and kept,
    // rounded, as rv.
    unsigned live[NSEG];
    float lg[NSEG];
    float rv[CH][CPL];
    bool first = true;
#pragma unroll
    for (int sg = 0; sg < NSEG; ++sg) {
      const int s0 = 32 * sg;
      live[sg] = __ballot_sync(FULL, s0 + lane < K && sj[s0 + lane] >= 0);
      lg[sg] = NEG;
      for (unsigned rem = live[sg]; rem;) {
        int ks[CH];
        bool on[CH];
        const unsigned before = rem;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          on[c] = rem != 0u;
          ks[c] = on[c] ? s0 + __ffs((int)rem) - 1 : 0;
          rem &= rem - 1u;
        }
        const unsigned taken = before & ~rem;     // this chunk's slots
        float kv[CH][CPL], vv[CH][CPL];
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const size_t at = (size_t)sj[ks[c]] * GC + g * C;
#pragma unroll
          for (int u = 0; u < CPL; ++u) {
            const int cc = lane + 32 * u;
            kv[c][u] = on[c] && cc < C ? A.kn[at + cc] : 0.f;
            vv[c][u] = first && on[c] && cc < C ? A.vn[at + cc] : 0.f;
          }
        }
        // each slot's lane partial sum, then one reduction for the chunk
        float part[CHP];
#pragma unroll
        for (int c = 0; c < CHP; ++c) part[c] = 0.f;
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const float4 d = sd[ks[c]];
#pragma unroll
          for (int u = 0; u < CPL; ++u) {
            const float k_e = kv[c][u] + d.x * wk0[u] + d.y * wk1[u] + d.z * wk2[u] +
                              d.w * we[u];
            part[c] += bf16_round(qv[u] * k_e);
          }
        }
        TRACE_STAMP(1, 11, r == 0);
        const float l = chunk_sum<CHP>(part, lane, taken) * inv_sqrt_c;
        if (taken >> lane & 1u) lg[sg] = l;
        if (first) {
#pragma unroll
          for (int c = 0; c < CH; ++c) {
            const float4 d = sd[ks[c]];
#pragma unroll
            for (int u = 0; u < CPL; ++u)
              rv[c][u] = bf16_round(fmaxf(
                  vv[c][u] + d.x * wv0[u] + d.y * wv1[u] + d.z * wv2[u], 0.f));
          }
        }
        first = false;
      }
    }

    TRACE_STAMP(1, 12, r == 0);
    // the row's max and denominator; each lane's alpha, rounded to bf16
    float mx = NEG;
#pragma unroll
    for (int sg = 0; sg < NSEG; ++sg)
      if (live[sg] >> lane & 1u) mx = fmaxf(mx, lg[sg]);
    // over lanes [0, span): the lanes that can hold a slot (K rounded up
    // to a power of two), or the warp past one ballot
    mx = span_reduce<true>(mx, span);
    float ex[NSEG], den = 0.f;
#pragma unroll
    for (int sg = 0; sg < NSEG; ++sg) {
      ex[sg] = live[sg] >> lane & 1u ? expf(lg[sg] - mx) : 0.f;
      den += ex[sg];
    }
    den = fmaxf(span_reduce<false>(den, span), 1e-30f);
    float al[NSEG];
#pragma unroll
    for (int sg = 0; sg < NSEG; ++sg) al[sg] = bf16_round(ex[sg] / den);

    TRACE_STAMP(1, 13, r == 0);
    // pass 2: sum alpha bf16(relu(V[j] + xjp Wv[:3])), sum alpha len and
    // sum alpha, in fp32; the first chunk from rv, later ones gathered
    float sl = 0.f, sa = 0.f;
    first = true;
#pragma unroll
    for (int sg = 0; sg < NSEG; ++sg) {
      const int s0 = 32 * sg;
      for (unsigned rem = live[sg]; rem;) {
        int ks[CH];
        bool on[CH];
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          on[c] = rem != 0u;
          ks[c] = on[c] ? s0 + __ffs((int)rem) - 1 : s0;
          rem &= rem - 1u;
        }
        float vv[CH][CPL];
        if (first) {
#pragma unroll
          for (int c = 0; c < CH; ++c)
#pragma unroll
            for (int u = 0; u < CPL; ++u) vv[c][u] = rv[c][u];
        } else {
#pragma unroll
          for (int c = 0; c < CH; ++c) {
            const size_t at = (size_t)sj[ks[c]] * GC + g * C;
#pragma unroll
            for (int u = 0; u < CPL; ++u) {
              const int cc = lane + 32 * u;
              vv[c][u] = on[c] && cc < C ? A.vn[at + cc] : 0.f;
            }
          }
#pragma unroll
          for (int c = 0; c < CH; ++c) {
            const float4 d = sd[ks[c]];
#pragma unroll
            for (int u = 0; u < CPL; ++u)
              vv[c][u] = bf16_round(fmaxf(
                  vv[c][u] + d.x * wv0[u] + d.y * wv1[u] + d.z * wv2[u], 0.f));
          }
        }
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const float alpha = __shfl_sync(FULL, al[sg], ks[c] - s0);
          if (!on[c]) continue;
#pragma unroll
          for (int u = 0; u < CPL; ++u) a[u] += alpha * vv[c][u];
          sa += alpha;
          sl += alpha * sd[ks[c]].w;
        }
        first = false;
      }
    }

    TRACE_STAMP(1, 14, r == 0);
    // the row's sum split into three bf16 parts for the product (zero past
    // C, and on a row with no live slot, whose output is its skip)
#pragma unroll
    for (int u = 0; u < CPL; ++u) {
      const int cc = lane + 32 * u;
      if (cc < Cp) {
        const float hi = bf16_round(a[u]), r1 = a[u] - hi;
        const float mid = bf16_round(r1);
        uint16_t* p = ph + 2 * (r * KP) + cc;
        p[0] = bf16_bits(hi);
        p[2 * EB_R * KP] = bf16_bits(mid);
        p[4 * EB_R * KP] = bf16_bits(r1 - mid);
      }
    }
    if (lane == 0) {
      s_len[r] = sl;
      s_sum[r] = sa;
    }
    TRACE_STAMP(1, 15, r == 0);
  }
  TRACE_STAMP(1, 3, true);
  __syncthreads();
  TRACE_STAMP(1, 4, true);
  mbar_wait(bar, 0);                      // Wl2[g] has landed
  TRACE_STAMP(1, 5, true);

  // the tile's rows times Wl2[g]: warp w takes m16 tile w % EB_MT and its
  // n8 column tiles w / EB_MT + EB_WPM t, three passes (hi, mid, lo)
  const int gr = lane >> 2, tq = lane & 3, n8 = Cp / 8;
  const int mt = warp % EB_MT, wn = warp / EB_MT;
  float acc[3][EB_NT][4];                  // a chain per part and tile
#pragma unroll
  for (int p = 0; p < 3; ++p)
#pragma unroll
    for (int t = 0; t < EB_NT; ++t)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[p][t][u] = 0.f;
  if (wn < n8) {
#pragma unroll
    for (int kp = 0; kp < MAX_C / 2; kp += 8) {
      if (kp >= Cp / 2) break;
      uint32_t ap[3][4];
#pragma unroll
      for (int p = 0; p < 3; ++p) {
        const uint32_t* x = ps + p * EB_R * KP + (mt * 16 + gr) * KP + kp + tq;
        ap[p][0] = x[0];
        ap[p][1] = x[8 * KP];
        ap[p][2] = x[4];
        ap[p][3] = x[8 * KP + 4];
      }
      // the column tiles' chains side by side (a tile past n8 reads
      // column 0's words and is not stored)
      uint32_t b[EB_NT][2];
#pragma unroll
      for (int t = 0; t < EB_NT; ++t) {
        const int nt = wn + t * EB_WPM;
        const uint32_t* wb = ws + ((nt < n8 ? nt : 0) * 8 + gr) * KP + kp + tq;
        b[t][0] = wb[0];
        b[t][1] = wb[4];
      }
#pragma unroll
      for (int p = 0; p < 3; ++p)
#pragma unroll
        for (int t = 0; t < EB_NT; ++t) mma_bf16(acc[p][t], ap[p], b[t]);
    }
  }
  __syncthreads();                        // every warp has read the rows
#pragma unroll
  for (int t = 0; t < EB_NT; ++t) {
    const int nt = wn + t * EB_WPM;
    if (nt >= n8) break;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      os[(mt * 16 + gr + (u >> 1) * 8) * OS + nt * 8 + 2 * tq + (u & 1)] =
          acc[0][t][u] + (acc[1][t][u] + acc[2][t][u]);
  }
  TRACE_STAMP(1, 6, true);
  cp_async_wait_all();                    // this thread's skip, bl2, We copies
  __syncthreads();
  TRACE_STAMP(1, 7, true);

  // out = product + bl2 sum alpha + We sum alpha len + skip, in rows of
  // 16-byte stores where aligned
  const int cq = (C + 3) / 4;
  for (int i = tid; i < nrows * cq; i += EB_THREADS) {
    const int r = i / cq, c = (i % cq) * 4;
    const float* o = os + r * OS + c;
    const float* s = s_sk + r * Cq + c;
    const float sl = s_len[r], sa = s_sum[r];
    float* y = A.out + gc0 + (size_t)r * GC + c;
    if (vec) {
      *reinterpret_cast<float4*>(y) = make_float4(
          o[0] + s_b2[c] * sa + s_we[c] * sl + s[0],
          o[1] + s_b2[c + 1] * sa + s_we[c + 1] * sl + s[1],
          o[2] + s_b2[c + 2] * sa + s_we[c + 2] * sl + s[2],
          o[3] + s_b2[c + 3] * sa + s_we[c + 3] * sl + s[3]);
    } else {
      for (int u = 0; u < 4 && c + u < C; ++u)
        y[u] = o[u] + s_b2[c + u] * sa + s_we[c + u] * sl + s[u];
    }
  }
  TRACE_END(1, 8);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

int launch_node_proj(const float* x_src, int Ns, int Fs, const float* x_dst,
                     int Nd, int Fd, const uint32_t* wpack, const float* bq,
                     const float* bk, const float* bv, const float* bsk,
                     int GC, float* kn, float* vn, float* q, float* sk,
                     cudaStream_t s) {
  // bulk copies take 16-byte aligned sources: the tiles of x start at a
  // multiple of 64 rows and the bias slices at a multiple of 128 columns,
  // so the bases must be aligned
  const void* ptrs[] = {x_src, x_dst, wpack, bq, bk, bv, bsk};
  for (const void* ptr : ptrs)
    if (!aligned16(ptr)) return cudaErrorMisalignedAddress;
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    err = cudaFuncSetAttribute(node_proj_bf16,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               np_smem(MAX_F, MAX_F, NB_MAX_STAGES));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  ProjSet P{{x_src, x_dst}, {Ns, Nd}, {Fs, Fd}, wpack, {bk, bv, bq, bsk},
            {kn, vn, q, sk}, GC, 1, 1, {0, 0, 0, 0}};
  // a tile a block on one stage while the grid fits one wave of blocks of
  // that size (3 an SM at the rollout's widths); past that, T tiles a
  // block on two stages, the grid one wave of two blocks an SM
  const int slices = np_gcp(GC) / NB_BN;
  int tiles[4], total = 0;
  for (int i = 0; i < 4; ++i) {
    tiles[i] = (P.N[i >> 1] + NB_BM - 1) / NB_BM;
    total += slices * tiles[i];
  }
  const int one_stage = 200 * 1024 / np_smem(Fs, Fd, 1);   // blocks an SM
  if (total > one_stage * sms) {
    const int target = 2 * sms;
    P.S = NB_MAX_STAGES;
    P.T = (total + target - 1) / target;
  }
  int blocks = 0;
  for (int i = 0; i < 4; ++i) {
    P.blocks[i] = slices * ((tiles[i] + P.T - 1) / P.T);
    blocks += P.blocks[i];
  }
  if (blocks > 0)
    node_proj_bf16<<<blocks, NB_THREADS, np_smem(Fs, Fd, P.S), s>>>(P);
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
        edge_attn_bf16<CPL, CH, NSEG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        eb_smem(32 * CPL, k));
    if (err != cudaSuccess) return static_cast<int>(err);
    k_set = k;
  }
  edge_attn_bf16<CPL, CH, NSEG><<<dim3((A.Nd + EB_R - 1) / EB_R, A.G), EB_THREADS,
                                  eb_smem(A.C, A.K), s>>>(A);
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
  if (!aligned16(A.wl2)) return cudaErrorMisalignedAddress;
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

// Fused bf16 conv forward: node_proj_bf16 then edge_attn_bf16, two
// launches. kn/vn [Ns, GC] (without the position lanes) and q/sk [Nd, GC]
// are fp32 scratch the caller allocates; out [Nd, GC] fp32. x_src and
// x_dst fp32 [N, F], 16-byte aligned; wpack the conv's pack (above); the
// biases, We and the position rows Wk[:3], Wv[:3] (read from wk, wv
// [F, GC]) fp32 in the JAX package's layout.
int edge_stage_bf16_forward(
    const float* x_src, int Ns, int Fs, const float* x_dst, int Nd, int Fd,
    const int* nbr, const float* elen, const float* nmask, int K,
    const uint32_t* wpack, const float* bq, const float* bk, const float* bv,
    const float* bsk, const float* wk, const float* wv, const float* bl2,
    const float* we, int G, int C, float* kn, float* vn, float* q, float* sk,
    float* out, void* stream) {
  if (!takes(Fs, Fd, G, C, K)) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGetLastError();   // clear any stale error
  int err = launch_node_proj(x_src, Ns, Fs, x_dst, Nd, Fd, wpack, bq, bk, bv,
                             bsk, G * C, kn, vn, q, sk, s);
  if (err) return err;
  err = launch_edge_attn({x_src, Ns, Fs, x_dst, Nd, Fd, nbr, elen, nmask, K, kn,
                          vn, q, sk, wpack + l2_offset(Fs, Fd, G * C), wk, wv,
                          bl2, we, G, C, out}, s);
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

// The bf16 node projections alone (one node_proj_bf16 launch):
// kn = bf16(x_src[:, 3:]) bf16(wk[3:]) + bk, vn likewise with wv,
// q = bf16(x_dst) bf16(wq) + bq, sk = bf16(x_dst) bf16(wsk) + bsk.
int edge_node_proj_bf16(
    const float* x_src, int Ns, int Fs, const float* x_dst, int Nd, int Fd,
    const uint32_t* wpack, const float* bq, const float* bk, const float* bv,
    const float* bsk, int GC, float* kn, float* vn, float* q, float* sk,
    void* stream) {
  if (!takes_proj(Fs, Fd)) return cudaErrorInvalidValue;
  cudaGetLastError();
  const int err = launch_node_proj(x_src, Ns, Fs, x_dst, Nd, Fd, wpack, bq,
                                   bk, bv, bsk, GC, kn, vn, q, sk,
                                   static_cast<cudaStream_t>(stream));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

// The bf16 edge kernel alone (one edge_attn_bf16 launch) on given bf16
// projections.
int edge_attn_bf16_forward(
    const float* x_src, int Ns, int Fs, const float* x_dst, int Nd, int Fd,
    const int* nbr, const float* elen, const float* nmask, int K,
    const float* kn, const float* vn, const float* q, const float* sk,
    const uint32_t* wpack, const float* wk, const float* wv, const float* bl2,
    const float* we, int G, int C, float* out, void* stream) {
  if (!takes(Fs, Fd, G, C, K)) return cudaErrorInvalidValue;
  cudaGetLastError();
  const int err = launch_edge_attn(
      {x_src, Ns, Fs, x_dst, Nd, Fd, nbr, elen, nmask, K, kn, vn, q, sk,
       wpack + l2_offset(Fs, Fd, G * C), wk, wv, bl2, we, G, C, out},
      static_cast<cudaStream_t>(stream));
  if (err) return err;
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of a block in bytes: node_proj_bf16 at widths Fs,
// Fd with one x stage (which = 1) or two (2), or edge_attn_bf16 (which =
// 0) at gate width C and K slots.
int edge_stage_bf16_smem(int which, int Fs, int Fd, int C, int K) {
  return which > 0 ? np_smem(Fs, Fd, which) : eb_smem(C, K);
}

}  // extern "C"
