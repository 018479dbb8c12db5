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
// edge in fp32. Two kernels per conv:
//
// node_proj_bf16: the four node projections as ONE grouped launch (the
//   block index picks the product and its 64 x 128 output tile): x_src on
//   lanes 3..F through Wk and Wv (lanes 0..2 load as zeros, which is Wk[:3]
//   and Wv[:3] zeroed), x_dst on every lane through Wq and Wskip. Bound:
//   bytes (the [N, 2 GC] fp32 outputs). The fp32 x rows and W columns are
//   rounded to bf16 as they are loaded (no cast launch, no cached copy),
//   packed two per word into shared memory (W transposed, so a word holds
//   the k pair of one column) with row strides that make every fragment
//   load conflict-free; 4 warps each take a 32 x 64 sub-tile on mma.sync
//   m16n8k16 bf16 (csrc/mma_bf16.cuh), one pass into fp32 accumulators.
//
// edge_attn_bf16: the gathers, the softmax and the value MLP's second
//   layer, a warp per destination row over its live slots (ballots of 32
//   slots, up to 8 live slots gathered together, as edge_attn). Alpha is
//   rounded after the division, so the softmax takes two passes over the
//   row: the first gathers the K rows and forms each logit as the sum of
//   the bf16-rounded products q * (K[j] + xjp Wk[:3] + len We), lane s of
//   the warp keeping slot s's logit; the row's max and denominator are
//   then warp reductions, and each lane rounds its slots' alpha. The second
//   gathers the V rows, rounds relu(V[j] + xjp Wv[:3]) to bf16 and sums
//   alpha * relu, alpha and alpha * len in fp32. The l2 product is linear,
//   so it runs once per destination ROW on that fp32 sum:
//     sum_k alpha_k (bf16(relu_k) Wl2 + bl2 + len_k We)
//       = (sum_k alpha_k bf16(relu_k)) Wl2 + bl2 sum alpha + We sum alpha len
//   To keep that product exact to fp32 order against the bf16 Wl2, the row
//   sum is split into three bf16 parts (hi + mid + lo carry 24 bits) and
//   multiplied on mma.sync m16n8k16 bf16, three passes into one fp32
//   accumulator. Bound: bytes, as edge_attn.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

constexpr int MAX_F = 128;      // node feature width the kernels take
constexpr int MAX_C = 128;      // gate width edge_attn_bf16 takes
constexpr int MAX_G = 8;
constexpr int MAX_K = 64;       // neighbor slots per row: two ballots of 32
constexpr unsigned FULL = 0xffffffffu;
constexpr float NEG = -1e30f;

// node_proj_bf16 tiling
constexpr int NB_BM = 64;                 // rows of a block tile
constexpr int NB_BN = 128;                // columns of a block tile
constexpr int NB_THREADS = 128;           // 4 warps in 2 x 2, each a quarter tile
constexpr int NB_MI = NB_BM / 2 / 16;     // m16 products per warp
constexpr int NB_NI = NB_BN / 2 / 8;      // n8 products per warp
constexpr int NB_KP = MAX_F / 2 + 4;      // row stride in k pairs: rows 4 banks apart
constexpr int NB_OS = NB_BN + 4;          // fp32 output tile row stride
constexpr int NB_SMEM = (NB_BM + NB_BN) * NB_KP * (int)sizeof(uint32_t);
static_assert(NB_BM * NB_OS * (int)sizeof(float) <= NB_SMEM, "node_proj_bf16 tiles");

// edge_attn_bf16 tiling: EB_R destination rows per block, EB_WARPS warps
constexpr int EB_R = 32;
constexpr int EB_WARPS = 16;
constexpr int EB_THREADS = EB_WARPS * 32;
constexpr int EB_MT = EB_R / 16;                          // m16 tiles
constexpr int EB_WPM = EB_WARPS / EB_MT;                  // warps per m16 tile
constexpr int EB_NT = (MAX_C / 8 + EB_WPM - 1) / EB_WPM;  // n8 tiles per warp

struct Proj {                             // y [N, GC] = x [N, F] w [F, GC] + b
  const float* x; const float* w; const float* b; float* y; int N, F, f0;
};
struct ProjSet {
  Proj p[4];
  int tiles[4];                           // block tiles of each product
  int GC;
};

// One NB_BM x NB_BN tile of one of the grouped products; lanes below f0
// of x load as zeros.
__global__ void __launch_bounds__(NB_THREADS) node_proj_bf16(ProjSet P) {
  extern __shared__ __align__(16) uint32_t nb_smem[];
  uint32_t* xs = nb_smem;                 // [NB_BM][NB_KP] x, k pairs
  uint32_t* ws = nb_smem + NB_BM * NB_KP; // [NB_BN][NB_KP] W transposed, k pairs
  int t = blockIdx.x, pi = 0;
  while (pi < 3 && t >= P.tiles[pi]) t -= P.tiles[pi++];
  const Proj pr = P.p[pi];
  const int GC = P.GC, F = pr.F, Fp = (F + 15) & ~15, KP = Fp / 2;
  const int ncol = (GC + NB_BN - 1) / NB_BN;
  const int row0 = (t / ncol) * NB_BM, col0 = (t % ncol) * NB_BN;
  const int nrows = min(NB_BM, pr.N - row0), ncols = min(NB_BN, GC - col0);

  // x rows [row0, row0 + NB_BM) and W columns [col0, col0 + NB_BN) over the
  // depth Fp, rounded to bf16 as they are loaded, zero-padded
  for (int i = threadIdx.x; i < NB_BM * KP; i += NB_THREADS) {
    const int r = i / KP, f = (i % KP) * 2;
    const float* src = pr.x + (size_t)(row0 + r) * F;
    const bool row = r < nrows;
    const float v0 = row && f >= pr.f0 && f < F ? src[f] : 0.f;
    const float v1 = row && f + 1 >= pr.f0 && f + 1 < F ? src[f + 1] : 0.f;
    xs[r * NB_KP + f / 2] = pack_bf16(v0, v1);
  }
  for (int i = threadIdx.x; i < NB_BN * KP; i += NB_THREADS) {
    const int n = i % NB_BN, f = (i / NB_BN) * 2;
    const float* src = pr.w + (size_t)f * GC + col0 + n;
    const bool col = n < ncols;
    const float v0 = col && f < F ? src[0] : 0.f;
    const float v1 = col && f + 1 < F ? src[GC] : 0.f;
    ws[n * NB_KP + f / 2] = pack_bf16(v0, v1);
  }
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int wr = (warp >> 1) * (NB_BM / 2), wc = (warp & 1) * (NB_BN / 2);
  const bool idle = wr >= nrows || wc >= ncols;   // sub-tile all padding
  float acc[NB_MI][NB_NI][4];
#pragma unroll
  for (int mi = 0; mi < NB_MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NB_NI; ++ni)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[mi][ni][u] = 0.f;

  for (int kp = 0; kp < KP && !idle; kp += 8) {
    uint32_t a[NB_MI][4];
#pragma unroll
    for (int mi = 0; mi < NB_MI; ++mi) {
      const uint32_t* xa = xs + (wr + mi * 16 + g) * NB_KP + kp + tq;
      a[mi][0] = xa[0];
      a[mi][1] = xa[8 * NB_KP];
      a[mi][2] = xa[4];
      a[mi][3] = xa[8 * NB_KP + 4];
    }
#pragma unroll
    for (int ni = 0; ni < NB_NI; ++ni) {
      const uint32_t* wb = ws + (wc + ni * 8 + g) * NB_KP + kp + tq;
      const uint32_t b[2] = {wb[0], wb[4]};
#pragma unroll
      for (int mi = 0; mi < NB_MI; ++mi) mma_bf16(acc[mi][ni], a[mi], b);
    }
  }

  // epilogue: the tile through shared memory (in place of x and W), then
  // its rows out with the bias, 16 bytes a thread where aligned
  __syncthreads();
  float* os = reinterpret_cast<float*>(nb_smem);
  if (!idle) {
#pragma unroll
    for (int mi = 0; mi < NB_MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NB_NI; ++ni)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          os[(wr + mi * 16 + g + (u >> 1) * 8) * NB_OS + wc + ni * 8 + 2 * tq + (u & 1)] =
              acc[mi][ni][u];
  }
  __syncthreads();
  const bool yvec = GC % 4 == 0 && ((reinterpret_cast<uintptr_t>(pr.y) |
                                     reinterpret_cast<uintptr_t>(pr.b)) & 15) == 0;
  for (int i = threadIdx.x; i < NB_BM * (NB_BN / 4); i += NB_THREADS) {
    const int r = i / (NB_BN / 4), c = (i % (NB_BN / 4)) * 4;
    if (r >= nrows || c >= ncols) continue;
    const float* o = os + r * NB_OS + c;
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

struct Attn {                             // edge_attn_bf16's inputs and output
  const float* x_src; int Ns, Fs;
  const float* x_dst; int Nd, Fd;
  const int* nbr; const float* elen; const float* nmask; int K;
  const float* kn; const float* vn; const float* q; const float* sk;
  const float* wk; const float* wv; const float* wl2; const float* bl2;
  const float* we; int G, C;
  float* out;
};

// Shared memory of an edge_attn_bf16 block at gate width C and K slots:
// Wl2[g] in bf16, transposed (a word holds the k pair of one column), Cp x
// Cp with C padded to a multiple of 16 and row stride eb_kp(Cp) words, so
// fragment loads are conflict-free; the tile's rows as three bf16 parts
// (hi, mid, lo) with the same stride (the fp32 product goes out through
// this space); sum alpha len and sum alpha per row; the slot table
// (xjp[:3], len) as float4 and the source row (-1 where masked).
__host__ __device__ inline int eb_cp(int C) { return (C + 15) & ~15; }
__host__ __device__ inline int eb_kp(int Cp) { return Cp / 2 + 4; }
__host__ __device__ inline int eb_smem(int C, int K) {
  const int Cp = eb_cp(C), KP = eb_kp(Cp);
  return (Cp * KP + 3 * EB_R * KP + 2 * EB_R + 5 * EB_R * K) * (int)sizeof(float);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}

// EB_R destination rows and gate blockIdx.y. CPL = ceil(C / 32) columns
// per lane; CH live slots gathered together; NSEG ballots of 32 slots
// cover K <= 32 * NSEG.
template <int CPL, int CH, int NSEG>
__global__ void __launch_bounds__(EB_THREADS, CH == 3 && CPL <= 3 ? 1024 / EB_THREADS : 1)
    edge_attn_bf16(Attn A) {
  extern __shared__ __align__(16) uint32_t eb_smem_u[];
  const int C = A.C, GC = A.G * C, g = blockIdx.y, K = A.K;
  const int Cp = eb_cp(C), KP = eb_kp(Cp), OS = Cp + 4;
  uint32_t* ws = eb_smem_u;                            // [Cp][KP] Wl2[g]^T
  uint32_t* ps = ws + Cp * KP;                         // [3][EB_R][KP] row parts
  uint16_t* ph = reinterpret_cast<uint16_t*>(ps);      // the same, as bf16
  float* os = reinterpret_cast<float*>(ps);            // [EB_R][OS] the product
  float* s_len = reinterpret_cast<float*>(ps + 3 * EB_R * KP);  // [EB_R]
  float* s_sum = s_len + EB_R;                                  // [EB_R]
  float4* s_d = reinterpret_cast<float4*>(s_sum + EB_R);        // [EB_R * K]
  int* s_j = reinterpret_cast<int*>(s_d + EB_R * K);            // [EB_R * K]
  const int row0 = blockIdx.x * EB_R;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  // Wl2[g] rounded to bf16, transposed into k pairs per column, zero-padded
  const float* w2 = A.wl2 + (size_t)g * C * C;
  for (int i = tid; i < Cp * (Cp / 2); i += EB_THREADS) {
    const int n = i % Cp, k = (i / Cp) * 2;
    const bool col = n < C;
    const float v0 = col && k < C ? w2[(size_t)k * C + n] : 0.f;
    const float v1 = col && k + 1 < C ? w2[(size_t)(k + 1) * C + n] : 0.f;
    ws[n * KP + k / 2] = pack_bf16(v0, v1);
  }

  // the tile's slot table, a thread per slot: the source row of a live
  // slot and (xjp[:3], len), xjp = bf16(bf16(x_j) - bf16(x_i) + wrap)
  for (int e = tid; e < EB_R * K; e += EB_THREADS) {
    const int i = row0 + e / K;
    const size_t at = (size_t)row0 * K + e;
    int j = -1;
    float4 d = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < A.Nd) {
      const float m = A.nmask[at], len = A.elen[at];
      const int jj = A.nbr[at];
      if (m > 0.f) {
        j = jj < 0 || jj >= A.Ns ? 0 : jj;
        float p[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float rel = bf16_round(A.x_src[(size_t)j * A.Fs + c]) -
                            bf16_round(A.x_dst[(size_t)i * A.Fd + c]);
          p[c] = bf16_round(rel + ((rel < -0.5f ? 1.f : 0.f) - (rel > 0.5f ? 1.f : 0.f)));
        }
        d = make_float4(p[0], p[1], p[2], len);
      }
    }
    s_j[e] = j;
    s_d[e] = d;
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
  const float inv_sqrt_c = 1.f / sqrtf((float)C);
  __syncthreads();

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

    // pass 1: the logit of each live slot, in ascending slot order, CH
    // slots at a time; lane s keeps the logit of slot s0 + s of ballot s0
    unsigned live[NSEG];
    float lg[NSEG];
#pragma unroll
    for (int sg = 0; sg < NSEG; ++sg) {
      const int s0 = 32 * sg;
      live[sg] = __ballot_sync(FULL, s0 + lane < K && sj[s0 + lane] >= 0);
      lg[sg] = NEG;
      for (unsigned rem = live[sg]; rem;) {
        int ks[CH];
        bool on[CH];
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          on[c] = rem != 0u;
          ks[c] = on[c] ? s0 + __ffs((int)rem) - 1 : 0;
          rem &= rem - 1u;
        }
        float kv[CH][CPL];
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          const size_t at = (size_t)sj[ks[c]] * GC + g * C;
#pragma unroll
          for (int u = 0; u < CPL; ++u) {
            const int cc = lane + 32 * u;
            kv[c][u] = on[c] && cc < C ? A.kn[at + cc] : 0.f;
          }
        }
#pragma unroll
        for (int c = 0; c < CH; ++c) {
          if (!on[c]) continue;               // the same for the whole warp
          const float4 d = sd[ks[c]];
          float part = 0.f;
#pragma unroll
          for (int u = 0; u < CPL; ++u) {
            const float k_e = kv[c][u] + d.x * wk0[u] + d.y * wk1[u] + d.z * wk2[u] +
                              d.w * we[u];
            part += bf16_round(qv[u] * k_e);
          }
          const float l = warp_sum(part) * inv_sqrt_c;
          if (lane == ks[c] - s0) lg[sg] = l;
        }
      }
    }

    // the row's max and denominator; each lane's alpha, rounded to bf16
    float mx = NEG;
#pragma unroll
    for (int sg = 0; sg < NSEG; ++sg)
      if (live[sg] >> lane & 1u) mx = fmaxf(mx, lg[sg]);
    mx = warp_max(mx);
    float ex[NSEG], den = 0.f;
#pragma unroll
    for (int sg = 0; sg < NSEG; ++sg) {
      ex[sg] = live[sg] >> lane & 1u ? expf(lg[sg] - mx) : 0.f;
      den += ex[sg];
    }
    den = fmaxf(warp_sum(den), 1e-30f);
    float al[NSEG];
#pragma unroll
    for (int sg = 0; sg < NSEG; ++sg) al[sg] = bf16_round(ex[sg] / den);

    // pass 2: sum alpha bf16(relu(V[j] + xjp Wv[:3])), sum alpha len and
    // sum alpha, in fp32
    float sl = 0.f, sa = 0.f;
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
          const float alpha = __shfl_sync(FULL, al[sg], ks[c] - s0);
          if (!on[c]) continue;
          const float4 d = sd[ks[c]];
#pragma unroll
          for (int u = 0; u < CPL; ++u)
            a[u] += alpha * bf16_round(fmaxf(
                vv[c][u] + d.x * wv0[u] + d.y * wv1[u] + d.z * wv2[u], 0.f));
          sa += alpha;
          sl += alpha * d.w;
        }
      }
    }

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
  }
  __syncthreads();

  // the tile's rows times Wl2[g]: warp w takes m16 tile w % EB_MT and its
  // n8 column tiles w / EB_MT + EB_WPM t, three passes (hi, mid, lo)
  const int gr = lane >> 2, tq = lane & 3, n8 = Cp / 8;
  const int mt = warp % EB_MT, wn = warp / EB_MT;
  float acc[EB_NT][4];
#pragma unroll
  for (int t = 0; t < EB_NT; ++t)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[t][u] = 0.f;
  for (int kp = 0; wn < n8 && kp < Cp / 2; kp += 8) {
    uint32_t ap[3][4];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const uint32_t* x = ps + p * EB_R * KP + (mt * 16 + gr) * KP + kp + tq;
      ap[p][0] = x[0];
      ap[p][1] = x[8 * KP];
      ap[p][2] = x[4];
      ap[p][3] = x[8 * KP + 4];
    }
#pragma unroll
    for (int t = 0; t < EB_NT; ++t) {
      const int nt = wn + t * EB_WPM;
      if (nt >= n8) break;
      const uint32_t* wb = ws + (nt * 8 + gr) * KP + kp + tq;
      const uint32_t b[2] = {wb[0], wb[4]};
      mma_bf16(acc[t], ap[2], b);
      mma_bf16(acc[t], ap[1], b);
      mma_bf16(acc[t], ap[0], b);
    }
  }
  __syncthreads();                        // every warp has read the rows
#pragma unroll
  for (int t = 0; t < EB_NT; ++t) {
    const int nt = wn + t * EB_WPM;
    if (nt >= n8) break;
#pragma unroll
    for (int u = 0; u < 4; ++u)
      os[(mt * 16 + gr + (u >> 1) * 8) * OS + nt * 8 + 2 * tq + (u & 1)] = acc[t][u];
  }
  __syncthreads();

  // out = product + bl2 sum alpha + We sum alpha len + skip, in rows of
  // 16-byte stores where aligned
  const int nrows = min(EB_R, A.Nd - row0), cq = (C + 3) / 4;
  const float* b2 = A.bl2 + g * C;
  const float* wg = A.we + g * C;
  const bool vec = C % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(A.out) | reinterpret_cast<uintptr_t>(A.sk) |
        reinterpret_cast<uintptr_t>(A.bl2) | reinterpret_cast<uintptr_t>(A.we)) & 15) == 0;
  for (int i = tid; i < nrows * cq; i += EB_THREADS) {
    const int r = i / cq, c = (i % cq) * 4;
    const float* o = os + r * OS + c;
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
        node_proj_bf16, cudaFuncAttributeMaxDynamicSharedMemorySize, NB_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  ProjSet P{{{x_src, wk, bk, kn, Ns, Fs, 3}, {x_src, wv, bv, vn, Ns, Fs, 3},
             {x_dst, wq, bq, q, Nd, Fd, 0}, {x_dst, wsk, bsk, sk, Nd, Fd, 0}},
            {0, 0, 0, 0}, GC};
  const int ncol = (GC + NB_BN - 1) / NB_BN;
  int total = 0;
  for (int i = 0; i < 4; ++i) {
    P.tiles[i] = (P.p[i].N + NB_BM - 1) / NB_BM * ncol;
    total += P.tiles[i];
  }
  if (total > 0) node_proj_bf16<<<total, NB_THREADS, NB_SMEM, s>>>(P);
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
// are fp32 scratch the caller allocates; out [Nd, GC] fp32. Inputs and
// weights fp32 in the JAX package's layout (w [F, GC], b [GC], wl2
// [G, C, C], bl2 [G, C], we [GC]), rounded to bf16 as they are loaded.
int edge_stage_bf16_forward(
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

// The bf16 node projections alone (one node_proj_bf16 launch):
// kn = bf16(x_src[:, 3:]) bf16(wk[3:]) + bk, vn likewise with wv,
// q = bf16(x_dst) bf16(wq) + bq, sk = bf16(x_dst) bf16(wsk) + bsk.
int edge_node_proj_bf16(
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

// The bf16 edge kernel alone (one edge_attn_bf16 launch) on given bf16
// projections.
int edge_attn_bf16_forward(
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
