// Single-launch topology editor of one rollout span, for Hopper.
//
// Replaces the TPU kernel graingraphnn_tpu/kernels/editor_pallas.py::_kernel
// (launched by update_fused), whose body is
// graingraphnn_tpu/kernels/editor_core.py::editor_core. Semantics are the
// plain editor's, graingraphnn_torch/kernels/editor_core.py, to the bit:
// pick up to max_switch live u<v jj edges with prob > threshold by
// descending probability (ties by column); run the grain eliminations
// (ring collapse by switches, grain deletion, forced deletions, two-sided
// cleanup); drop collapsed edges from the switch list; run the switches;
// finish with a two-sided cleanup. The moving melt pool's active windows
// aj [NJ] and ag [NG] gate the switches (both endpoints active) and the
// ring collapses (the grain and every junction of its ring active); the
// static melt pool passes all ones. The cleanup mask cg [NG] (null: all
// ones) limits the two-sided cleanups to the grains it sets; the
// working-set editor passes its footprint.
//
// Bound on this card: latency and instruction issue. The edit is a chain
// of dependent steps, each a few scalar decisions fed by a scan over E_pp
// (~6.4k columns at 120 um) or E_pq (~6.3k). The operations and bytes are
// tiny (the state is ~120 KB); the time is the chain's length times the
// cost of one step: its scans' reads and instructions, spread over the
// block, plus its barriers. Design: ONE block of EDITOR_THREADS threads
// per lane (512 measured fastest; 256 and 1024 slower); a batched rollout
// edits its B independent lanes in one launch of B blocks, the TPU
// kernel's vmap grid dimension, each at one lane's budgets. Every thread
// of a block runs the same control flow on the same scalar values; each
// scan (first-k search, count, rewrite) is spread over the block with a
// chunked prefix sum and __syncthreads(). Block-uniform state (the
// state's description, the switch lists, first-k results) lives once in
// shared memory, written by thread 0 behind a barrier, so no thread keeps
// large per-thread arrays in local memory. E_pq's junction row only
// changes to -1, so an index of each junction's E_pq columns, built once
// per launch, answers the switch's queries about junctions by walking a
// list of ~3 columns. Per switch: the two grain rings and the two border
// tests from that index (a scan where a key is not a junction), ONE pass
// for the two joint-neighbor first-k queries (the pair shares its reads),
// a warp-parallel lookahead, one barrier between the switch's reads and
// its writes, and ONE pass for the writes to E_pp. The candidate switches
// come from one compaction and a rank-based top-max_switch selection; a
// ring collapse finds the grains across all its ring edges in two
// atomicMin passes. The state's arrays stay in device memory, where L1
// and L2 hold them through the chain: a version that staged them in
// shared memory saved only ~5 % at 120 um.
//
// Build with -fmad=false: the switch reposition and the displacement
// rollback are float32 arithmetic whose results the plain version
// computes without contraction.

#include <cuda_runtime.h>
#include <limits.h>

#ifndef EDITOR_THREADS
#define EDITOR_THREADS 512
#endif

namespace {

constexpr int NT = EDITOR_THREADS;
constexpr int WARP = 32;
constexpr int NWARP = NT / WARP;
constexpr unsigned FULL = 0xffffffffu;
constexpr int RING = 16;           // RING_MAX: junction ring of one grain
constexpr int MAX_MS = 64;         // max_switch the kernel takes
constexpr int MAX_GE = 16;         // grain-event budget the kernel takes
constexpr int MAX_TWOSIDED = 8;
constexpr int KMAX = 64;           // longest first-k query
constexpr float JOINT_SCALE = 5.0f;

static_assert(NT % WARP == 0 && NWARP <= WARP && KMAX <= NT, "block shape");

struct Ed {                        // editor state
  int* pp0; int* pp1; int EP;      // E_pp rows (source, destination joint)
  int* pq0; int* pq1; int EQ;      // E_pq rows (joint, grain)
  int NJ;
  float* xj; int xs;               // [NJ, xs] joint features, position in 0:2
  float* yj;                       // [NJ, 2] predicted displacement
  int* mg; int NG;                 // grain mask
  int* mj;                         // joint mask
  const int* aj; const int* ag;    // active windows of joints and grains
  const int* cg;                   // two-sided cleanup's grain mask (null: all)
  int* cnt;                        // [num_grains] ring counts
  float* cp; int* cc;              // [EP] candidate switches (prob, column)
  int* jo; int* jc;                // E_pq columns by junction (index_junctions)
  int ptr;                         // append cursor
};

// Block-uniform state lives in shared memory, one copy for the block: the
// editor state's description and every list the control flow keeps.
// Each is written by thread 0 (or one entry per thread) behind a barrier.
__shared__ Ed s_S;
__shared__ int s_fk[4 * KMAX];     // first-k results of up to four queries
__shared__ int s_red[4 * NWARP];   // per-warp partials of up to four sums
__shared__ int s_np[RING];         // ring junctions of the grain in collapse
__shared__ int s_L2[RING];         // its ring edges, in ring-slot order
__shared__ int s_Nq[RING];         // the grain across each ring edge
__shared__ int s_c1[RING], s_c2[RING];   // first two E_pq columns of each ring junction
__shared__ int s_ev[RING];         // the collapse's switches
__shared__ int s_forces[2 * RING]; // the grains they force out
__shared__ int s_L1[MAX_MS];       // the candidate switches, in order
__shared__ int s_L1c[MAX_MS];      // those still live after eliminations
__shared__ int s_fs[2 * MAX_MS];   // the grains they force out
__shared__ int s_va[KMAX], s_vb[KMAX];   // endpoints of a switch list
__shared__ int s_tg[KMAX], s_drop[KMAX]; // two-sided cleanup targets, deletions

__device__ __forceinline__ int gi(const int* v, int n, int i) {
  return (i >= 0 && i < n) ? v[i] : 0;
}
__device__ __forceinline__ float& posx(Ed& S, int j) { return S.xj[(size_t)j * S.xs]; }
__device__ __forceinline__ float& posy(Ed& S, int j) { return S.xj[(size_t)j * S.xs + 1]; }
__device__ __forceinline__ float gfx(Ed& S, int j) { return (j >= 0 && j < S.NJ) ? posx(S, j) : 0.f; }
__device__ __forceinline__ float gfy(Ed& S, int j) { return (j >= 0 && j < S.NJ) ? posy(S, j) : 0.f; }
__device__ __forceinline__ void put(int* v, int n, int i, int val) {
  if (i >= 0 && i < n) v[i] = val;
}
// v[i] of three values held in registers (i in 0..2).
__device__ __forceinline__ int at3(int v0, int v1, int v2, int i) {
  return i == 0 ? v0 : (i == 1 ? v1 : v2);
}

// Image of p nearest pc on the unit torus.
__device__ __forceinline__ float wrap_s(float p, float pc) {
  const float rel = p - pc;
  return (p - (rel > 0.5f ? 1.f : 0.f)) + (rel < -0.5f ? 1.f : 0.f);
}

// Exclusive block-wide prefix sums (in thread order) of Q per-thread
// counts c[Q] into r[Q], and their totals into tot[Q]. One barrier: the
// caller passes another before s_red is written again.
template <int Q>
__device__ void block_scan(const int* c, int* r, int* tot) {
  const int lane = threadIdx.x & (WARP - 1), wid = threadIdx.x / WARP;
  int inc[Q];
#pragma unroll
  for (int q = 0; q < Q; ++q) inc[q] = c[q];
  for (int o = 1; o < WARP; o <<= 1) {
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const int y = __shfl_up_sync(FULL, inc[q], o);
      if (lane >= o) inc[q] += y;
    }
  }
  if (lane == WARP - 1)
#pragma unroll
    for (int q = 0; q < Q; ++q) s_red[q * NWARP + wid] = inc[q];
  __syncthreads();
#pragma unroll
  for (int q = 0; q < Q; ++q) {
    r[q] = inc[q] - c[q];
    tot[q] = 0;
    for (int w = 0; w < NWARP; ++w) {
      if (w < wid) r[q] += s_red[q * NWARP + w];
      tot[q] += s_red[q * NWARP + w];
    }
  }
}

// Two first-k queries over one range in this thread's chunk [lo, hi):
// q(i) gives query 0's predicate in bit 0 and query 1's in bit 1, from one
// read of the arrays. Counts the matches and keeps the bits of the first
// 32 elements ...
template <class QP>
__device__ __forceinline__ void chunk_count(QP q, int lo, int hi, int& c0,
                                            int& c1, unsigned& m0, unsigned& m1) {
  c0 = c1 = 0;
  m0 = m1 = 0;
#pragma unroll 4
  for (int i = lo; i < hi; ++i) {
    const int b = q(i);
    c0 += b & 1;
    c1 += b >> 1;
    if (i - lo < 32) {
      m0 |= (unsigned)(b & 1) << (i - lo);
      m1 |= (unsigned)(b >> 1) << (i - lo);
    }
  }
}

// ... and writes the matches of query `bit` ranked from r on, up to k: the
// kept bits, then the predicate again past them.
template <class QP>
__device__ __forceinline__ void chunk_write(QP q, int bit, int lo, int hi,
                                           unsigned m, int r, int k, int* out) {
  for (; m && r < k; m &= m - 1) out[r++] = lo + __ffs(m) - 1;
  for (int i = lo + 32; i < hi && r < k; ++i)
    if ((q(i) >> bit) & 1) out[r++] = i;
}

// Four first-k queries in one pass and two barriers, two over [0, na) by
// the bits of qa(i) and two over [0, nb) by those of qb(i): query j puts
// its first k[j] ascending matches into s_fk[j * KMAX, +k[j]), fill[j]
// beyond its population. Returns the populations. Chunked: thread t scans
// [t*chunk, (t+1)*chunk) of each range.
template <class QA, class QB>
__device__ int4 first_k4(QA qa, int na, QB qb, int nb, int4 k, int4 fill) {
  const int t = threadIdx.x;
  const int cha = (na + NT - 1) / NT, chb = (nb + NT - 1) / NT;
  const int loa = min(na, t * cha), hia = min(na, loa + cha);
  const int lob = min(nb, t * chb), hib = min(nb, lob + chb);
  int c[4], r[4], tot[4];
  unsigned m[4];
  chunk_count(qa, loa, hia, c[0], c[1], m[0], m[1]);
  chunk_count(qb, lob, hib, c[2], c[3], m[2], m[3]);
  block_scan<4>(c, r, tot);
  chunk_write(qa, 0, loa, hia, m[0], r[0], k.x, s_fk);
  chunk_write(qa, 1, loa, hia, m[1], r[1], k.y, s_fk + KMAX);
  chunk_write(qb, 0, lob, hib, m[2], r[2], k.z, s_fk + 2 * KMAX);
  chunk_write(qb, 1, lob, hib, m[3], r[3], k.w, s_fk + 3 * KMAX);
  const int ks[4] = {k.x, k.y, k.z, k.w}, fs[4] = {fill.x, fill.y, fill.z, fill.w};
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (t < ks[j] && t >= tot[j]) s_fk[j * KMAX + t] = fs[j];
  __syncthreads();
  return make_int4(tot[0], tot[1], tot[2], tot[3]);
}

struct Never {                     // the predicates of unused queries
  __device__ int operator()(int) const { return 0; }
};

// Two first-k queries over one range, in one pass: the first ka
// ascending i < n with pa(i) into s_fk[0, ka), the first kb with pb(i)
// into s_fk[KMAX, +kb). Returns the populations.
template <class PA, class PB>
__device__ int2 first_k2(PA pa, PB pb, int n, int ka, int kb, int fill) {
  const int4 c = first_k4([&](int i) { return (pa(i) ? 1 : 0) | (pb(i) ? 2 : 0); },
                          n, Never(), 0, make_int4(ka, kb, 0, 0),
                          make_int4(fill, fill, 0, 0));
  return make_int2(c.x, c.y);
}

// One first-k query: the first k ascending i < n with pred(i) into
// s_fk[0, k); returns the population.
template <class P>
__device__ int first_k(P pred, int n, int k, int fill) {
  return first_k4([&](int i) { return pred(i) ? 1 : 0; }, n, Never(), 0,
                  make_int4(k, 0, 0, 0), make_int4(fill, 0, 0, 0)).x;
}

// Counts of two predicates over [0, n), in one pass.
template <class PA, class PB>
__device__ int2 count2(PA pa, PB pb, int n) {
  int ca = 0, cb = 0;
#pragma unroll 4
  for (int i = threadIdx.x; i < n; i += NT) {
    ca += pa(i) ? 1 : 0;
    cb += pb(i) ? 1 : 0;
  }
  const int c[2] = {ca, cb};
  int r[2], tot[2];
  block_scan<2>(c, r, tot);
  __syncthreads();
  return make_int2(tot[0], tot[1]);
}

// (p, i) precedes (q, j) in descending-probability, ascending-column order.
__device__ __forceinline__ bool before(float p, int i, float q, int j) {
  return p > q || (p == q && i < j);
}

// First two true positions of three flags, 0 where absent.
__device__ __forceinline__ void first2_of3(bool b0, bool b1, bool b2, int& f, int& s) {
  f = b0 ? 0 : (b1 ? 1 : (b2 ? 2 : 0));
  s = (b1 && f < 1) ? 1 : ((b2 && f < 2) ? 2 : 0);
}

// The E_pq columns of each junction j in [0, NJ), ascending, into
// jc[jo[j], jo[j + 1]). E_pq's junction row only ever changes to -1 (a
// deleted column), so a listed column is live while pq0 still names j,
// and a junction's first-k query is a walk of its short list.
__device__ __noinline__ void index_junctions(Ed& S) {
  const int t = threadIdx.x, NJ = S.NJ;
  int* const jo = S.jo;
  int* const jc = S.jc;
  const int* const pq0 = S.pq0;
  for (int j = t; j <= NJ; j += NT) jo[j] = 0;
  __syncthreads();
  for (int i = t; i < S.EQ; i += NT) {
    const int j = pq0[i];
    if (j >= 0 && j < NJ) atomicAdd(&jo[j], 1);
  }
  __syncthreads();
  // inclusive prefix sums of the counts: the end of each list
  const int ch = (NJ + NT - 1) / NT;
  const int lo = min(NJ, t * ch), hi = min(NJ, lo + ch);
  int c = 0, r, tot;
  for (int j = lo; j < hi; ++j) c += jo[j];
  block_scan<1>(&c, &r, &tot);
  for (int j = lo; j < hi; ++j) {
    r += jo[j];
    jo[j] = r;
  }
  if (t == 0) jo[NJ] = tot;
  __syncthreads();
  // each column at the end of its list, counting down: jo[j] ends at the
  // list's start
  for (int i = t; i < S.EQ; i += NT) {
    const int j = pq0[i];
    if (j >= 0 && j < NJ) jc[atomicSub(&jo[j], 1) - 1] = i;
  }
  __syncthreads();
  for (int j = t; j < NJ; j += NT) {           // each list ascending
    for (int a = jo[j] + 1; a < jo[j + 1]; ++a) {
      const int v = jc[a];
      int b = a - 1;
      for (; b >= jo[j] && jc[b] > v; --b) jc[b + 1] = jc[b];
      jc[b + 1] = v;
    }
  }
  __syncthreads();
}

// The first three live E_pq columns of junction j in [0, NJ), ascending,
// `fill` beyond: first_k(pq0 == j, 3, fill) from the index.
__device__ __forceinline__ void junction_first3(const Ed& S, int j, int fill,
                                                int& c0, int& c1, int& c2) {
  c0 = c1 = c2 = fill;
  int n = 0;
  for (int e = S.jo[j]; e < S.jo[j + 1] && n < 3; ++e) {
    const int i = S.jc[e];
    if (S.pq0[i] != j) continue;
    if (n == 0) c0 = i;
    else if (n == 1) c1 = i;
    else c2 = i;
    ++n;
  }
}

// Whether junction j in [0, NJ) has a live E_pq column to `grain`.
__device__ __forceinline__ bool junction_has(const Ed& S, int j, int grain) {
  for (int e = S.jo[j]; e < S.jo[j + 1]; ++e) {
    const int i = S.jc[e];
    if (S.pq0[i] == j && S.pq1[i] == grain) return true;
  }
  return false;
}

// One neighbor switch of jj column e; events[pos..n_events) is the
// lookahead. Returns the grains it forces out (-1 when none).
__device__ __noinline__ int2 switch_one(Ed& S, int e, const int* events, int K,
                                        int pos, int n_events, int elim_grain) {
  const int EP = S.EP, EQ = S.EQ;
  int* const pp0 = S.pp0;
  int* const pp1 = S.pp1;
  int* const pq0 = S.pq0;
  int* const pq1 = S.pq1;
  const int p1 = gi(pp0, EP, e), p2 = gi(pp1, EP, e);
  bool valid = e >= 0 && p1 >= 0 && p2 >= 0;
  const int p1s = valid ? p1 : 0, p2s = valid ? p2 : 0;
  // melt pool window: no switch touches an inactive joint
  valid = valid && gi(S.aj, S.NJ, p1s) > 0 && gi(S.aj, S.NJ, p2s) > 0;

  // the grain rings (3 each) and other joint neighbors (2 each) of both
  // endpoints: the rings from the junction index where both endpoints are
  // junctions (else by a scan), the neighbors by a scan, in one pass
  int a0, a1, a2, b0, b1, b2, c0, c1, d0, d1;
  auto pp_pair = [&](int i) {
    const int u = pp0[i], v = pp1[i];
    return (u == p1s && v != p2s ? 1 : 0) | (u == p2s && v != p1s ? 2 : 0);
  };
  if (p1s < S.NJ && p2s < S.NJ) {
    junction_first3(S, p1s, EQ - 1, a0, a1, a2);
    junction_first3(S, p2s, EQ - 1, b0, b1, b2);
    first_k4(pp_pair, EP, Never(), 0, make_int4(2, 2, 0, 0),
             make_int4(EP - 1, EP - 1, 0, 0));
    c0 = s_fk[0]; c1 = s_fk[1]; d0 = s_fk[KMAX]; d1 = s_fk[KMAX + 1];
  } else {
    first_k4([&](int i) {
               const int v = pq0[i];
               return (v == p1s ? 1 : 0) | (v == p2s ? 2 : 0);
             }, EQ, pp_pair, EP, make_int4(3, 3, 2, 2),
             make_int4(EQ - 1, EQ - 1, EP - 1, EP - 1));
    a0 = s_fk[0]; a1 = s_fk[1]; a2 = s_fk[2];
    b0 = s_fk[KMAX]; b1 = s_fk[KMAX + 1]; b2 = s_fk[KMAX + 2];
    c0 = s_fk[2 * KMAX]; c1 = s_fk[2 * KMAX + 1];
    d0 = s_fk[3 * KMAX]; d1 = s_fk[3 * KMAX + 1];
  }
  const int q10 = gi(pq1, EQ, a0), q11 = gi(pq1, EQ, a1), q12 = gi(pq1, EQ, a2);
  const int q20 = gi(pq1, EQ, b0), q21 = gi(pq1, EQ, b1), q22 = gi(pq1, EQ, b2);
  auto in_q2 = [&](int q) { return q == q20 || q == q21 || q == q22; };
  auto in_q1 = [&](int q) { return q == q10 || q == q11 || q == q12; };
  const bool i20 = in_q2(q10), i21 = in_q2(q11), i22 = in_q2(q12);
  const bool i10 = in_q1(q20), i11 = in_q1(q21), i12 = in_q1(q22);
  valid = valid && i20 + i21 + i22 == 2 && i10 + i11 + i12 == 2;

  int sh0, sh1, e1, e2, unused;
  first2_of3(i20, i21, i22, sh0, sh1);
  first2_of3(!i20, !i21, !i22, e1, unused);
  first2_of3(!i10, !i11, !i12, e2, unused);
  const int shrink_q1 = at3(q10, q11, q12, sh0), shrink_q2 = at3(q10, q11, q12, sh1);
  const int expand_q1 = at3(q10, q11, q12, e1), expand_q2 = at3(q20, q21, q22, e2);
  auto index_or0 = [&](int v) { return q20 == v ? 0 : (q21 == v ? 1 : (q22 == v ? 2 : 0)); };
  int qs10 = at3(a0, a1, a2, sh0), qs11 = at3(a0, a1, a2, sh1);
  int qs20 = at3(b0, b1, b2, index_or0(shrink_q1));
  int qs21 = at3(b0, b1, b2, index_or0(shrink_q2));

  const int fn1 = gi(pp1, EP, c0), fn2 = gi(pp1, EP, d0);
  bool border1, border2;           // fn1, fn2 border shrink_q1
  if (fn1 >= 0 && fn1 < S.NJ && fn2 >= 0 && fn2 < S.NJ) {
    border1 = junction_has(S, fn1, shrink_q1);
    border2 = junction_has(S, fn2, shrink_q1);
  } else {
    const int2 border = count2(
        [&](int i) { return pq0[i] == fn1 && pq1[i] == shrink_q1; },
        [&](int i) { return pq0[i] == fn2 && pq1[i] == shrink_q1; }, EQ);
    border1 = border.x > 0;
    border2 = border.y > 0;
  }
  int pn10 = border1 ? c0 : c1, pn11 = border1 ? c1 : c0;
  int pn20 = border2 ? d0 : d1, pn21 = border2 ? d1 : d0;
  const int sq1_p1 = gi(pp1, EP, pn10), sq2_p1 = gi(pp1, EP, pn11);
  const int sq1_p2 = gi(pp1, EP, pn20), sq2_p2 = gi(pp1, EP, pn21);

  const bool degenerate = sq1_p1 == sq1_p2 || sq2_p1 == sq2_p2;
  valid = valid && (elim_grain >= 0 || !degenerate);
  const int force1 = (valid && sq1_p1 == sq1_p2 && shrink_q1 != elim_grain) ? shrink_q1 : -1;
  const int force2 = (valid && sq2_p1 == sq2_p2 && shrink_q2 != elim_grain) ? shrink_q2 : -1;

  // periodic midpoint reposition
  const float x1x = gfx(S, p1s), x1y = gfy(S, p1s);
  const float x2x = gfx(S, p2s), x2y = gfy(S, p2s);
  const float cx = 0.5f * (x1x + wrap_s(x2x, x1x));
  const float cy = 0.5f * (x1y + wrap_s(x2y, x1y));
  const float n2x = wrap_s(cx, x2x), n2y = wrap_s(cy, x2y);

  // lookahead over the remaining events (this one included): lane l of
  // every warp takes events pos + l, pos + 32 + l, ...; the warp ORs the
  // four flags, so every thread holds them without a barrier
  int h = 0;
  const int n_look = min(n_events, K);
  for (int k0 = pos; k0 < n_look; k0 += WARP) {
    const int k = k0 + (int)(threadIdx.x & (WARP - 1));
    if (k < n_look && events[k] >= 0) {
      const int na = gi(pp0, EP, events[k]), nb = gi(pp1, EP, events[k]);
      h |= (na == sq1_p2 || nb == sq1_p2) ? 1 : 0;
      h |= (na == sq2_p2 || nb == sq2_p2) ? 2 : 0;
      h |= (na == sq1_p1 || nb == sq1_p1) ? 4 : 0;
      h |= (na == sq2_p1 || nb == sq2_p1) ? 8 : 0;
    }
  }
  for (int o = WARP / 2; o > 0; o >>= 1) h |= __shfl_xor_sync(FULL, h, o);
  const bool h0 = h & 1, h1 = h & 2, h2 = h & 4, h3 = h & 8;
  bool swap = true;
  if (h0 && !h1) swap = false;
  if (h1 && !h0) swap = true;
  if (h2 && !h3) swap = true;
  if (h3 && !h2) swap = false;
  if (swap) {
    int t;
    t = qs10; qs10 = qs11; qs11 = t;
    t = qs20; qs20 = qs21; qs21 = t;
    t = pn10; pn10 = pn11; pn11 = t;
    t = pn20; pn20 = pn21; pn21 = t;
  }
  const int sq1_p2_f = swap ? sq2_p2 : sq1_p2;
  const int sq2_p1_f = swap ? sq1_p1 : sq2_p1;
  (void)qs10;
  (void)qs21;
  (void)pn10;
  (void)pn21;

  // every thread has read what this switch decides on (the rings in E_pq,
  // the neighbours and the lookahead's columns in E_pp, the positions)
  // before any thread writes them
  __syncthreads();
  if (!valid) return make_int2(force1, force2);
  if (threadIdx.x == 0) {
    if (p1s < S.NJ) { posx(S, p1s) = cx; posy(S, p1s) = cy; }
    if (p2s < S.NJ) { posx(S, p2s) = n2x; posy(S, p2s) = n2y; }
    put(pq1, EQ, qs11, expand_q2);
    put(pq1, EQ, qs20, expand_q1);
  }
  // One pass over E_pp: the two single writes to pp0, then the two pp1
  // rewrites in order. Each column's new value depends on that column
  // alone, so applying the steps column by column is applying them pass
  // by pass: the second rewrite reads pp1 as the first left it.
#pragma unroll 4
  for (int i = threadIdx.x; i < EP; i += NT) {
    int u = pp0[i], v = pp1[i];
    const int u0 = u, v0 = v;
    if (i == pn11) u = p2s;
    if (i == pn20) u = p1s;
    if (u == sq1_p2_f && v == p2s) v = p1s;
    if (u == sq2_p1_f && v == p1s) v = p2s;
    if (u != u0) pp0[i] = u;
    if (v != v0) pp1[i] = v;
  }
  __syncthreads();
  return make_int2(force1, force2);
}

// Roll back the predicted displacement of every joint the events (a
// shared list) touch, run the switches in order, then zero those joints'
// displacement and gradients. forces[2 * K] (shared) receives the forced
// grains.
__device__ __noinline__ void switch_events(Ed& S, const int* events, int K,
                                           int n_events, int elim_grain,
                                           int* forces) {
  const int n_trip = min(n_events, K);
  const int t = threadIdx.x;
  if (t < n_trip) {
    const bool ok = events[t] >= 0;
    s_va[t] = ok ? gi(S.pp0, S.EP, events[t]) : -1;
    s_vb[t] = ok ? gi(S.pp1, S.EP, events[t]) : -1;
  }
  for (int k = t; k < 2 * K; k += NT) forces[k] = -1;
  __syncthreads();
  auto touched = [&](int j) {
    for (int k = 0; k < n_trip; ++k)
      if (s_va[k] == j || s_vb[k] == j) return true;
    return false;
  };
  for (int j = t; j < S.NJ; j += NT) {
    if (touched(j)) {
      posx(S, j) = posx(S, j) + (-S.yj[2 * j] / JOINT_SCALE);
      posy(S, j) = posy(S, j) + (-S.yj[2 * j + 1] / JOINT_SCALE);
    }
  }
  __syncthreads();
  for (int i = 0; i < n_trip; ++i) {
    const int2 f = switch_one(S, events[i], events, K, i, n_events, elim_grain);
    if (t == 0) { forces[2 * i] = f.x; forces[2 * i + 1] = f.y; }
  }
  for (int j = t; j < S.NJ; j += NT) {
    if (touched(j)) {
      S.yj[2 * j] = 0.f;
      S.yj[2 * j + 1] = 0.f;
      S.xj[(size_t)j * S.xs + 6] = 0.f;
      S.xj[(size_t)j * S.xs + 7] = 0.f;
    }
  }
  __syncthreads();
}

// Delete a two-sided grain: its two junctions merge into one new jj edge
// pair appended at the cursor. Returns whether the grain was deleted.
__device__ __noinline__ bool delete_grain(Ed& S, int grain) {
  const int EP = S.EP, EQ = S.EQ;
  int* const pp0 = S.pp0;
  int* const pp1 = S.pp1;
  int* const pq0 = S.pq0;
  int* const pq1 = S.pq1;
  const int g = grain >= 0 ? grain : 0;
  const int n_ring = first_k([&](int i) { return pq1[i] == g; }, EQ, 2, EQ - 1);
  if (!(grain >= 0 && n_ring == 2)) return false;
  const int p1 = gi(pq0, EQ, s_fk[0]), p2 = gi(pq0, EQ, s_fk[1]);
  const int2 n = first_k2([&](int i) { return pp0[i] == p1 && pp1[i] != p2; },
                          [&](int i) { return pp0[i] == p2 && pp1[i] != p1; }, EP, 1, 1,
                          EP - 1);
  const int i1 = s_fk[0], i2 = s_fk[KMAX];
  if (n.x == 0 || n.y == 0) return false;
  const int np1 = gi(pp1, EP, i1), np2 = gi(pp1, EP, i2);
  const int ptr = S.ptr;
  __syncthreads();                   // every thread has read S.ptr
  if (threadIdx.x == 0) {
    put(pp0, EP, ptr, np1);
    put(pp0, EP, ptr + 1, np2);
    put(pp1, EP, ptr, np2);
    put(pp1, EP, ptr + 1, np1);
    put(S.mg, S.NG, g, 0);
    put(S.mj, S.NJ, p1, 0);
    put(S.mj, S.NJ, p2, 0);
    S.ptr = ptr + 2;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < EQ; i += NT) {
    if (pq1[i] == g || pq0[i] == p1 || pq0[i] == p2) {
      pq0[i] = -1;
      pq1[i] = -1;
    }
  }
  for (int i = threadIdx.x; i < EP; i += NT) {
    const int u = pp0[i], v = pp1[i];
    if (u == p1 || v == p1 || u == p2 || v == p2) {
      pp0[i] = -1;
      pp1[i] = -1;
    }
  }
  __syncthreads();
  return true;
}

// Collapse grain g's junction ring by switching all but two of its ring
// edges, in ascending predicted darea of the grain across each edge.
// Writes s_ev[RING] and s_forces[2 * RING]; returns whether it ran.
__device__ __noinline__ bool ring_collapse(Ed& S, int g, const float* yg0) {
  const int EP = S.EP, EQ = S.EQ;
  int* const pp0 = S.pp0;
  int* const pp1 = S.pp1;
  int* const pq0 = S.pq0;
  int* const pq1 = S.pq1;
  const int t = threadIdx.x;
  if (t < RING) s_ev[t] = -1;
  if (t < 2 * RING) s_forces[t] = -1;
  const int gs = g >= 0 ? g : 0;
  const int ring_n = first_k([&](int i) { return pq1[i] == gs; }, EQ, RING, EQ - 1);
  if (!(g >= 0 && ring_n > 0 && ring_n <= RING && gi(S.ag, S.NG, gs) > 0))
    return false;
  if (t < ring_n) s_np[t] = gi(pq0, EQ, s_fk[t]);
  __syncthreads();
  // melt pool window: every junction of the ring active (one block-wide
  // count, so every thread takes the same branch)
  const int n_inactive = count2([&](int r) { return gi(S.aj, S.NJ, s_np[r]) <= 0; },
                                Never(), ring_n).x;
  if (n_inactive > 0) return false;
  auto slot = [&](int v) {
    for (int r = 0; r < ring_n; ++r)
      if (s_np[r] == v) return r;
    return -1;
  };

  // ring edges: jj columns u<v with both ends on the ring, in ascending
  // order of their ring-slot pair (stable)
  const int n_l2 = first_k([&](int i) {
    const int u = pp0[i], v = pp1[i];
    return u < v && slot(u) >= 0 && slot(v) >= 0;
  }, EP, RING, EP - 1);
  if (n_l2 != ring_n) return false;
  if (t == 0) {
    int rank[RING];
    bool taken[RING];
    for (int r = 0; r < n_l2; ++r) {
      const int i = slot(pp0[s_fk[r]]), j = slot(pp1[s_fk[r]]);
      const int lo = min(i, j), hi = max(i, j);
      rank[r] = lo * (2 * RING - lo - 1) / 2 + (hi - lo - 1);
      taken[r] = false;
    }
    for (int o = 0; o < n_l2; ++o) {
      int best = -1;
      for (int r = 0; r < n_l2; ++r)
        if (!taken[r] && (best < 0 || rank[r] < rank[best])) best = r;
      taken[best] = true;
      s_L2[o] = s_fk[best];
    }
  }
  __syncthreads();

  // the grain shared across each ring edge, all distinct. For every ring
  // junction at once, its first two E_pq columns (ascending) whose grain
  // is not g: the least such column, then the least above it, by atomicMin
  // in two passes; EQ - 1 where there is none (the first-k fill).
  if (t < ring_n) { s_c1[t] = INT_MAX; s_c2[t] = INT_MAX; }
  __syncthreads();
  for (int i = t; i < EQ; i += NT) {
    if (pq1[i] == gs) continue;
    const int sl = slot(pq0[i]);
    if (sl >= 0) atomicMin(&s_c1[sl], i);
  }
  __syncthreads();
  for (int i = t; i < EQ; i += NT) {
    if (pq1[i] == gs) continue;
    const int sl = slot(pq0[i]);
    if (sl >= 0 && i > s_c1[sl]) atomicMin(&s_c2[sl], i);
  }
  __syncthreads();
  auto col = [&](int c) { return c == INT_MAX ? EQ - 1 : c; };
  for (int r = 0; r < n_l2; ++r) {
    const int s1 = slot(gi(pp0, EP, s_L2[r])), s2 = slot(gi(pp1, EP, s_L2[r]));
    const int nq10 = gi(pq1, EQ, col(s_c1[s1])), nq11 = gi(pq1, EQ, col(s_c2[s1]));
    const int nq20 = gi(pq1, EQ, col(s_c1[s2])), nq21 = gi(pq1, EQ, col(s_c2[s2]));
    const bool first_in = nq10 == nq20 || nq10 == nq21;
    const bool second_in = nq11 == nq20 || nq11 == nq21;
    if (!(first_in || second_in)) return false;
    if (t == 0) s_Nq[r] = first_in ? nq10 : nq11;
  }
  __syncthreads();
  for (int r = 0; r < n_l2; ++r)
    for (int u = r + 1; u < n_l2; ++u)
      if (s_Nq[r] == s_Nq[u]) return false;

  // ascending predicted darea of the shared grain; the last two stay
  const int n_events = max(n_l2 - 2, 0);
  if (t == 0) {
    float key[RING];
    bool taken[RING];
    for (int r = 0; r < n_l2; ++r) {
      key[r] = (s_Nq[r] >= 0 && s_Nq[r] < S.NG) ? yg0[s_Nq[r]] : 0.f;
      taken[r] = false;
    }
    for (int o = 0; o < n_events; ++o) {
      int best = -1;
      for (int r = 0; r < n_l2; ++r)
        if (!taken[r] && (best < 0 || key[r] < key[best])) best = r;
      taken[best] = true;
      s_ev[o] = s_L2[best];
    }
  }
  __syncthreads();
  switch_events(S, s_ev, RING, n_events, gs, s_forces);
  return true;
}

// Delete every grain left with one or two live ring edges (at most
// `budget`, ascending id) whose cleanup mask is set into s_drop[budget]
// (-1 where none). The ring
// counts are rebuilt from E_pq with atomics on S.cnt.
__device__ __noinline__ void two_sided_cleanup(Ed& S, int num_grains, int budget) {
  int* const cnt = S.cnt;
  int* const pq1 = S.pq1;
  for (int g = threadIdx.x; g < num_grains; g += NT) cnt[g] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < S.EQ; i += NT) {
    const int v = pq1[i];
    if (v >= 0 && v < num_grains) atomicAdd(&cnt[v], 1);
  }
  __syncthreads();
  const int* const cg = S.cg;
  first_k([&](int g) { return cnt[g] > 0 && cnt[g] <= 2 && (!cg || cg[g]); },
          num_grains, budget, -1);
  if ((int)threadIdx.x < budget) s_tg[threadIdx.x] = s_fk[threadIdx.x];
  __syncthreads();
  for (int k = 0; k < budget; ++k) {
    const int t = s_tg[k];
    const bool done = t >= 0 && delete_grain(S, t);
    if (threadIdx.x == 0) s_drop[k] = done ? t : -1;
  }
  __syncthreads();
}

// Candidate switches into s_L1[MS]: live u<v columns over threshold, by
// descending probability, ties by column, -1 fills. One compaction of the
// candidates into S.cp/S.cc (in column order), then each candidate's rank
// among them: those ranked below MS land in s_L1 at their rank.
__device__ __noinline__ void select_switches(Ed& S, const float* prob,
                                             float threshold, int MS) {
  const int t = threadIdx.x;
  const int* const pp0 = S.pp0;
  const int* const pp1 = S.pp1;
  float* const cp = S.cp;
  int* const cc = S.cc;
  auto cand = [&](int c) {
    const int u = pp0[c], v = pp1[c];
    return prob[c] > threshold && u < v && u >= 0;
  };
  const int chunk = (S.EP + NT - 1) / NT;
  const int lo = min(S.EP, t * chunk), hi = min(S.EP, lo + chunk);
  int c = 0;
  for (int i = lo; i < hi; ++i) c += cand(i) ? 1 : 0;
  int r, n;
  block_scan<1>(&c, &r, &n);
  for (int i = lo; i < hi; ++i)
    if (cand(i)) { cp[r] = prob[i]; cc[r++] = i; }
  if (t < MS) s_L1[t] = -1;
  __syncthreads();
  for (int i = t; i < n; i += NT) {
    const float p = cp[i];
    const int col = cc[i];
    int rank = 0;
    for (int j = 0; j < n && rank < MS; ++j) rank += before(cp[j], cc[j], p, col);
    if (rank < MS) s_L1[rank] = col;
  }
  __syncthreads();
}

// The whole edit of one span on the state S.
__device__ __noinline__ void edit(Ed& S, const float* prob, const float* yg0,
                                  const int* ge, int GE, float threshold,
                                  int num_grains, int MS, int* sw, int* extra,
                                  int max_extra) {
  const int tid = threadIdx.x;
  for (int i = tid; i < max_extra; i += NT) extra[i] = -1;
  __syncthreads();
  int n_extra = 0;                   // thread 0 appends to extra
  auto put_extra = [&](const int* vals, int n) {
    if (tid != 0) return;
    for (int i = 0; i < n; ++i) {
      if (vals[i] < 0) continue;
      if (n_extra < max_extra) extra[n_extra] = vals[i];
      ++n_extra;
    }
  };

  index_junctions(S);
  select_switches(S, prob, threshold, MS);

  // grain eliminations
  const int ts_budget = max(MAX_TWOSIDED, GE);
  for (int i = 0; i < GE; ++i) {
    const int g = ge[i];
    if (g < 0) continue;
    const bool ok = ring_collapse(S, g, yg0);
    __syncthreads();
    put_extra(s_forces, 2 * RING);
    if (!ok) continue;
    delete_grain(S, g);
    for (int k = 0; k < 2 * RING; ++k)
      if (s_forces[k] >= 0) delete_grain(S, s_forces[k]);
    if (tid == 0)
      for (int k = 0; k < RING; ++k)
        for (int m = 0; m < MS; ++m)
          if (s_ev[k] >= 0 && s_L1[m] == s_ev[k]) s_L1[m] = -1;
    __syncthreads();
    two_sided_cleanup(S, num_grains, ts_budget);
  }

  // pending switches whose column is still live, in order
  if (tid == 0) {
    int n_sw = 0;
    for (int m = 0; m < MS; ++m)
      if (s_L1[m] >= 0 && gi(S.pp0, S.EP, s_L1[m]) >= 0) s_L1c[n_sw++] = s_L1[m];
    for (int m = n_sw; m < MS; ++m) s_L1c[m] = -1;
    s_red[0] = n_sw;
  }
  __syncthreads();
  const int n_sw = s_red[0];
  __syncthreads();
  switch_events(S, s_L1c, MS, n_sw, -1, s_fs);
  put_extra(s_fs, 2 * MS);
  if (tid == 0) {
    for (int m = 0; m < MS; ++m) {
      sw[2 * m] = s_L1c[m] >= 0 ? gi(S.pp0, S.EP, s_L1c[m]) : -1;
      sw[2 * m + 1] = s_L1c[m] >= 0 ? gi(S.pp1, S.EP, s_L1c[m]) : -1;
    }
  }
  two_sided_cleanup(S, num_grains, ts_budget);
  put_extra(s_drop, ts_budget);
}

// G holds lane 0's state arrays and scratch, all in device memory; block
// b edits lane b, whose arrays follow lane 0's at a fixed stride (the
// state's own sizes; scr for the scratch). Lanes share no memory.
__global__ void __launch_bounds__(NT) editor_kernel(
    Ed G, int scr, const float* __restrict__ prob,
    const float* __restrict__ yg0, const int* __restrict__ ge, int GE,
    float threshold, int num_grains, int MS, int* ptr_io, int* sw,
    int* extra, int max_extra) {
  const size_t b = blockIdx.x;
  if (threadIdx.x == 0) {
    s_S = G;
    s_S.pp0 += b * 2 * G.EP;
    s_S.pp1 += b * 2 * G.EP;
    s_S.pq0 += b * 2 * G.EQ;
    s_S.pq1 += b * 2 * G.EQ;
    s_S.xj += b * G.NJ * G.xs;
    s_S.yj += b * 2 * G.NJ;
    s_S.mg += b * G.NG;
    s_S.mj += b * G.NJ;
    s_S.aj += b * G.NJ;
    s_S.ag += b * G.NG;
    if (G.cg) s_S.cg += b * G.NG;
    s_S.cnt += b * scr;
    s_S.cp += b * scr;
    s_S.cc += b * scr;
    s_S.jo += b * scr;
    s_S.jc += b * scr;
    s_S.ptr = ptr_io[b];
  }
  __syncthreads();
  edit(s_S, prob + b * G.EP, yg0 + b * G.NG, ge + b * GE, GE, threshold,
       num_grains, MS, sw + b * 2 * MS, extra + b * max_extra, max_extra);
  __syncthreads();
  if (threadIdx.x == 0) ptr_io[b] = s_S.ptr;
}

}  // namespace

extern "C" {

const char* ggnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One span's edit of B independent lanes in place, one block per lane.
// Each lane's arrays are contiguous and follow the previous lane's: pp
// [B, 2, EP], pq [B, 2, EQ], xj [B, NJ, xs], yj [B, NJ, 2], mg [B, NG],
// mj [B, NJ], ptr [B], prob [B, EP], yg0 [B, NG], ge [B, GE], the active
// windows aj [B, NJ] and ag [B, NG], the cleanup mask cg [B, NG] (null:
// every grain); writes sw [B, MS, 2] and extra
// [B, max_extra]. scratch is [B, num_grains + 2 * EP + NJ + 1 + EQ]
// int32. MS and GE are per-lane budgets.
int editor_update(int B, int* pp, int EP, int* pq, int EQ, float* xj,
                  int NJ, int xs, float* yj, int* mg, int* mj, int NG,
                  const float* prob, const float* yg0, const int* ge, int GE,
                  const int* aj, const int* ag, const int* cg,
                  float threshold, int num_grains, int MS, int* ptr, int* sw,
                  int* extra, int* scratch, int max_extra, void* stream) {
  const int ts_budget = GE > MAX_TWOSIDED ? GE : MAX_TWOSIDED;
  if (B < 1 || MS < 0 || MS > MAX_MS || GE < 0 || GE > MAX_GE ||
      ts_budget > KMAX || xs < 8 || EP < 1 || EQ < 1 || num_grains > NG)
    return cudaErrorInvalidValue;
  const int scr = num_grains + 2 * EP + NJ + 1 + EQ;
  int* const jo = scratch + num_grains + 2 * EP;
  Ed S{pp, pp + EP, EP, pq, pq + EQ, EQ, NJ, xj, xs, yj,
       mg, NG, mj, aj, ag, cg, scratch,
       reinterpret_cast<float*>(scratch + num_grains),
       scratch + num_grains + EP, jo, jo + NJ + 1, 0};
  cudaGetLastError();   // clear any stale error
  editor_kernel<<<B, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      S, scr, prob, yg0, ge, GE, threshold, num_grains, MS, ptr, sw, extra,
      max_extra);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
