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
// finish with a two-sided cleanup.
//
// Bound on this card: latency. The edit is a chain of dependent steps,
// each a few scalar decisions fed by a scan over E_pp (~6.4k columns at
// 120 um) or E_pq (~6.3k). The operations and bytes are tiny (the whole
// state is ~200 KB); the time is the chain's length times the latency of
// one step. Design: ONE block of EDITOR_THREADS threads with the state in
// device memory (L1/L2-resident after first touch). Every thread runs the
// same control flow on the same scalar values; each scan (first-k search,
// count, arg-max, masked rewrite) is spread over the block with a
// chunked prefix sum and __syncthreads(); single-element writes are made
// by thread 0 followed by a barrier. No other block runs, so nothing is
// ever launched per event. Staging the state in shared memory is left for
// a later version.
//
// Build with -fmad=false: the switch reposition and the displacement
// rollback are float32 arithmetic whose results the plain version
// computes without contraction.

#include <cuda_runtime.h>

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
constexpr int BIG = 1 << 30;
constexpr float JOINT_SCALE = 5.0f;

static_assert(NT % WARP == 0 && NWARP <= WARP && KMAX <= NT, "block shape");

__shared__ int s_fk[KMAX];         // first-k results
__shared__ int s_np[RING];         // ring junctions of the grain in collapse
__shared__ int s_red[NWARP];       // per-warp partials
__shared__ float s_redf[NWARP];

struct Ed {                        // editor state, in device memory
  int* pp0; int* pp1; int EP;      // E_pp rows (source, destination joint)
  int* pq0; int* pq1; int EQ;      // E_pq rows (joint, grain)
  float* xj; int NJ; int xs;       // joint features, row stride xs
  float* yj;                       // [NJ, 2] predicted displacement
  int* mg; int NG;                 // grain mask
  int* mj;                         // joint mask
  int* cnt;                        // [num_grains] scratch
  int ptr;                         // append cursor (same in every thread)
};

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

// Image of p nearest pc on the unit torus.
__device__ __forceinline__ float wrap_s(float p, float pc) {
  const float rel = p - pc;
  return (p - (rel > 0.5f ? 1.f : 0.f)) + (rel < -0.5f ? 1.f : 0.f);
}

__device__ int block_sum(int v) {
  for (int o = WARP / 2; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  if ((threadIdx.x & (WARP - 1)) == 0) s_red[threadIdx.x / WARP] = v;
  __syncthreads();
  int t = 0;
  for (int w = 0; w < NWARP; ++w) t += s_red[w];
  __syncthreads();
  return t;
}

// First k ascending indices i < n with pred(i) into s_fk (fill beyond the
// population); returns the population. Chunked: thread t scans
// [t*chunk, (t+1)*chunk), a block prefix sum ranks its matches.
template <class P>
__device__ int first_k(P pred, int n, int k, int fill) {
  const int chunk = (n + NT - 1) / NT;
  const int lo = min(n, (int)threadIdx.x * chunk), hi = min(n, lo + chunk);
  int c = 0;
  for (int i = lo; i < hi; ++i) c += pred(i) ? 1 : 0;
  const int lane = threadIdx.x & (WARP - 1), wid = threadIdx.x / WARP;
  int inc = c;
  for (int o = 1; o < WARP; o <<= 1) {
    const int y = __shfl_up_sync(FULL, inc, o);
    if (lane >= o) inc += y;
  }
  if (lane == WARP - 1) s_red[wid] = inc;
  __syncthreads();
  int rank = inc - c, total = 0;
  for (int w = 0; w < NWARP; ++w) {
    if (w < wid) rank += s_red[w];
    total += s_red[w];
  }
  for (int i = lo; i < hi && rank < k; ++i)
    if (pred(i)) s_fk[rank++] = i;
  if ((int)threadIdx.x < k && (int)threadIdx.x >= total) s_fk[threadIdx.x] = fill;
  __syncthreads();
  return total;
}

template <class P>
__device__ int count(P pred, int n) {
  int c = 0;
  for (int i = threadIdx.x; i < n; i += NT) c += pred(i) ? 1 : 0;
  return block_sum(c);
}

// (p, i) precedes (q, j) in descending-probability, ascending-column order.
__device__ __forceinline__ bool before(float p, int i, float q, int j) {
  return p > q || (p == q && i < j);
}

// Block-wide first (p, i) in that order; every thread gets the result.
__device__ void block_best(float& p, int& i) {
  for (int o = WARP / 2; o > 0; o >>= 1) {
    const float q = __shfl_xor_sync(FULL, p, o);
    const int j = __shfl_xor_sync(FULL, i, o);
    if (before(q, j, p, i)) { p = q; i = j; }
  }
  if ((threadIdx.x & (WARP - 1)) == 0) {
    s_redf[threadIdx.x / WARP] = p;
    s_red[threadIdx.x / WARP] = i;
  }
  __syncthreads();
  for (int w = 0; w < NWARP; ++w)
    if (before(s_redf[w], s_red[w], p, i)) { p = s_redf[w]; i = s_red[w]; }
  __syncthreads();
}

// First two true positions of three flags, 0 where absent.
__device__ __forceinline__ void first2_of3(const bool* b, int& f, int& s) {
  f = b[0] ? 0 : (b[1] ? 1 : (b[2] ? 2 : 0));
  s = (b[1] && f < 1) ? 1 : ((b[2] && f < 2) ? 2 : 0);
}

__device__ __forceinline__ int index_or0(const int* q, int v) {
  return q[0] == v ? 0 : (q[1] == v ? 1 : (q[2] == v ? 2 : 0));
}

// One neighbor switch of jj column e; events[pos..n_events) is the
// lookahead. Writes the grains it forces out (-1 when none).
__device__ __noinline__ void switch_one(Ed& S, int e, const int* events, int K,
                                        int pos, int n_events, int elim_grain,
                                        int& force1, int& force2) {
  const int EP = S.EP, EQ = S.EQ;
  const int p1 = gi(S.pp0, EP, e), p2 = gi(S.pp1, EP, e);
  bool valid = e >= 0 && p1 >= 0 && p2 >= 0;
  const int p1s = valid ? p1 : 0, p2s = valid ? p2 : 0;

  int a[3], b[3], c[2], d[2];
  first_k([&](int i) { return S.pq0[i] == p1s; }, EQ, 3, EQ - 1);
  for (int t = 0; t < 3; ++t) a[t] = s_fk[t];
  first_k([&](int i) { return S.pq0[i] == p2s; }, EQ, 3, EQ - 1);
  for (int t = 0; t < 3; ++t) b[t] = s_fk[t];
  first_k([&](int i) { return S.pp0[i] == p1s && S.pp1[i] != p2s; }, EP, 2, EP - 1);
  c[0] = s_fk[0]; c[1] = s_fk[1];
  first_k([&](int i) { return S.pp0[i] == p2s && S.pp1[i] != p1s; }, EP, 2, EP - 1);
  d[0] = s_fk[0]; d[1] = s_fk[1];

  int q1[3], q2[3];
  for (int t = 0; t < 3; ++t) { q1[t] = gi(S.pq1, EQ, a[t]); q2[t] = gi(S.pq1, EQ, b[t]); }
  bool in2[3], in1[3], nin2[3], nin1[3];
  int s2 = 0, s1 = 0;
  for (int t = 0; t < 3; ++t) {
    in2[t] = q1[t] == q2[0] || q1[t] == q2[1] || q1[t] == q2[2];
    in1[t] = q2[t] == q1[0] || q2[t] == q1[1] || q2[t] == q1[2];
    nin2[t] = !in2[t];
    nin1[t] = !in1[t];
    s2 += in2[t];
    s1 += in1[t];
  }
  valid = valid && s2 == 2 && s1 == 2;

  int sh0, sh1, e1, e2, unused;
  first2_of3(in2, sh0, sh1);
  first2_of3(nin2, e1, unused);
  first2_of3(nin1, e2, unused);
  const int shrink_q1 = q1[sh0], shrink_q2 = q1[sh1];
  const int expand_q1 = q1[e1], expand_q2 = q2[e2];
  int qs10 = a[sh0], qs11 = a[sh1];
  int qs20 = b[index_or0(q2, shrink_q1)], qs21 = b[index_or0(q2, shrink_q2)];

  const int fn1 = gi(S.pp1, EP, c[0]), fn2 = gi(S.pp1, EP, d[0]);
  const bool border1 = count([&](int i) { return S.pq0[i] == fn1 && S.pq1[i] == shrink_q1; }, EQ) > 0;
  const bool border2 = count([&](int i) { return S.pq0[i] == fn2 && S.pq1[i] == shrink_q1; }, EQ) > 0;
  int pn10 = border1 ? c[0] : c[1], pn11 = border1 ? c[1] : c[0];
  int pn20 = border2 ? d[0] : d[1], pn21 = border2 ? d[1] : d[0];
  const int sq1_p1 = gi(S.pp1, EP, pn10), sq2_p1 = gi(S.pp1, EP, pn11);
  const int sq1_p2 = gi(S.pp1, EP, pn20), sq2_p2 = gi(S.pp1, EP, pn21);

  const bool degenerate = sq1_p1 == sq1_p2 || sq2_p1 == sq2_p2;
  valid = valid && (elim_grain >= 0 || !degenerate);
  force1 = (valid && sq1_p1 == sq1_p2 && shrink_q1 != elim_grain) ? shrink_q1 : -1;
  force2 = (valid && sq2_p1 == sq2_p2 && shrink_q2 != elim_grain) ? shrink_q2 : -1;

  // periodic midpoint reposition
  const float x1x = gfx(S, p1s), x1y = gfy(S, p1s);
  const float x2x = gfx(S, p2s), x2y = gfy(S, p2s);
  const float cx = 0.5f * (x1x + wrap_s(x2x, x1x));
  const float cy = 0.5f * (x1y + wrap_s(x2y, x1y));
  const float n2x = wrap_s(cx, x2x), n2y = wrap_s(cy, x2y);

  // lookahead over the remaining events (this one included)
  bool h0 = false, h1 = false, h2 = false, h3 = false;
  for (int k = pos; k < min(n_events, K); ++k) {
    if (events[k] < 0) continue;
    const int na = gi(S.pp0, EP, events[k]), nb = gi(S.pp1, EP, events[k]);
    h0 = h0 || na == sq1_p2 || nb == sq1_p2;
    h1 = h1 || na == sq2_p2 || nb == sq2_p2;
    h2 = h2 || na == sq1_p1 || nb == sq1_p1;
    h3 = h3 || na == sq2_p1 || nb == sq2_p1;
  }
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

  if (!valid) return;
  if (threadIdx.x == 0) {
    if (p1s < S.NJ) { posx(S, p1s) = cx; posy(S, p1s) = cy; }
    if (p2s < S.NJ) { posx(S, p2s) = n2x; posy(S, p2s) = n2y; }
    put(S.pq1, EQ, qs11, expand_q2);
    put(S.pq1, EQ, qs20, expand_q1);
    put(S.pp0, EP, pn11, p2s);
    put(S.pp0, EP, pn20, p1s);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < EP; i += NT)
    if (S.pp0[i] == sq1_p2_f && S.pp1[i] == p2s) S.pp1[i] = p1s;
  __syncthreads();
  for (int i = threadIdx.x; i < EP; i += NT)
    if (S.pp0[i] == sq2_p1_f && S.pp1[i] == p1s) S.pp1[i] = p2s;
  __syncthreads();
}

// Roll back the predicted displacement of every joint the events touch,
// run the switches in order, then zero those joints' displacement and
// gradients. forces[2 * K] receives the forced grains.
__device__ __noinline__ void switch_events(Ed& S, const int* events, int K,
                                           int n_events, int elim_grain,
                                           int* forces) {
  const int n_trip = min(n_events, K);
  int va[KMAX], vb[KMAX];
  for (int k = 0; k < n_trip; ++k) {
    const bool ok = events[k] >= 0;
    va[k] = ok ? gi(S.pp0, S.EP, events[k]) : -1;
    vb[k] = ok ? gi(S.pp1, S.EP, events[k]) : -1;
  }
  auto touched = [&](int j) {
    for (int k = 0; k < n_trip; ++k)
      if (va[k] == j || vb[k] == j) return true;
    return false;
  };
  for (int j = threadIdx.x; j < S.NJ; j += NT) {
    if (touched(j)) {
      posx(S, j) = posx(S, j) + (-S.yj[2 * j] / JOINT_SCALE);
      posy(S, j) = posy(S, j) + (-S.yj[2 * j + 1] / JOINT_SCALE);
    }
  }
  __syncthreads();
  for (int k = 0; k < 2 * K; ++k) forces[k] = -1;
  for (int i = 0; i < n_trip; ++i)
    switch_one(S, events[i], events, K, i, n_events, elim_grain,
               forces[2 * i], forces[2 * i + 1]);
  for (int j = threadIdx.x; j < S.NJ; j += NT) {
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
  const int g = grain >= 0 ? grain : 0;
  const int n_ring = first_k([&](int i) { return S.pq1[i] == g; }, EQ, 2, EQ - 1);
  if (!(grain >= 0 && n_ring == 2)) return false;
  const int p1 = gi(S.pq0, EQ, s_fk[0]), p2 = gi(S.pq0, EQ, s_fk[1]);
  const int n1 = first_k([&](int i) { return S.pp0[i] == p1 && S.pp1[i] != p2; }, EP, 1, EP - 1);
  const int i1 = s_fk[0];
  const int n2 = first_k([&](int i) { return S.pp0[i] == p2 && S.pp1[i] != p1; }, EP, 1, EP - 1);
  const int i2 = s_fk[0];
  if (n1 == 0 || n2 == 0) return false;
  const int np1 = gi(S.pp1, EP, i1), np2 = gi(S.pp1, EP, i2);
  if (threadIdx.x == 0) {
    put(S.pp0, EP, S.ptr, np1);
    put(S.pp0, EP, S.ptr + 1, np2);
    put(S.pp1, EP, S.ptr, np2);
    put(S.pp1, EP, S.ptr + 1, np1);
    put(S.mg, S.NG, g, 0);
    put(S.mj, S.NJ, p1, 0);
    put(S.mj, S.NJ, p2, 0);
  }
  S.ptr += 2;
  __syncthreads();
  for (int i = threadIdx.x; i < EQ; i += NT) {
    if (S.pq1[i] == g || S.pq0[i] == p1 || S.pq0[i] == p2) {
      S.pq0[i] = -1;
      S.pq1[i] = -1;
    }
  }
  for (int i = threadIdx.x; i < EP; i += NT) {
    const int u = S.pp0[i], v = S.pp1[i];
    if (u == p1 || v == p1 || u == p2 || v == p2) {
      S.pp0[i] = -1;
      S.pp1[i] = -1;
    }
  }
  __syncthreads();
  return true;
}

// Collapse grain g's junction ring by switching all but two of its ring
// edges, in ascending predicted darea of the grain across each edge.
// Writes events[RING] and forces[2 * RING]; returns whether it ran.
__device__ __noinline__ bool ring_collapse(Ed& S, int g, const float* yg0,
                                           int* events, int* forces) {
  const int EP = S.EP, EQ = S.EQ;
  for (int r = 0; r < RING; ++r) events[r] = -1;
  for (int r = 0; r < 2 * RING; ++r) forces[r] = -1;
  const int gs = g >= 0 ? g : 0;
  const int ring_n = first_k([&](int i) { return S.pq1[i] == gs; }, EQ, RING, EQ - 1);
  if (!(g >= 0 && ring_n > 0 && ring_n <= RING)) return false;
  if ((int)threadIdx.x < ring_n) s_np[threadIdx.x] = gi(S.pq0, EQ, s_fk[threadIdx.x]);
  __syncthreads();
  auto slot = [&](int v) {
    for (int r = 0; r < ring_n; ++r)
      if (s_np[r] == v) return r;
    return -1;
  };

  // ring edges: jj columns u<v with both ends on the ring
  const int n_l2 = first_k([&](int i) {
    const int u = S.pp0[i], v = S.pp1[i];
    return u < v && slot(u) >= 0 && slot(v) >= 0;
  }, EP, RING, EP - 1);
  if (n_l2 != ring_n) return false;
  int cols[RING], rank[RING], L2[RING];
  bool taken[RING];
  for (int r = 0; r < n_l2; ++r) {
    cols[r] = s_fk[r];
    const int i = slot(S.pp0[cols[r]]), j = slot(S.pp1[cols[r]]);
    const int lo = min(i, j), hi = max(i, j);
    rank[r] = lo * (2 * RING - lo - 1) / 2 + (hi - lo - 1);
    taken[r] = false;
  }
  for (int o = 0; o < n_l2; ++o) {           // stable ascending order
    int best = -1;
    for (int r = 0; r < n_l2; ++r)
      if (!taken[r] && (best < 0 || rank[r] < rank[best])) best = r;
    taken[best] = true;
    L2[o] = cols[best];
  }

  // the grain shared across each ring edge, all distinct
  int Nq[RING];
  for (int r = 0; r < n_l2; ++r) {
    const int ep1 = gi(S.pp0, EP, L2[r]), ep2 = gi(S.pp1, EP, L2[r]);
    first_k([&](int i) { return S.pq0[i] == ep1 && S.pq1[i] != gs; }, EQ, 2, EQ - 1);
    const int nq10 = gi(S.pq1, EQ, s_fk[0]), nq11 = gi(S.pq1, EQ, s_fk[1]);
    first_k([&](int i) { return S.pq0[i] == ep2 && S.pq1[i] != gs; }, EQ, 2, EQ - 1);
    const int nq20 = gi(S.pq1, EQ, s_fk[0]), nq21 = gi(S.pq1, EQ, s_fk[1]);
    const bool first_in = nq10 == nq20 || nq10 == nq21;
    const bool second_in = nq11 == nq20 || nq11 == nq21;
    if (!(first_in || second_in)) return false;
    Nq[r] = first_in ? nq10 : nq11;
  }
  for (int r = 0; r < n_l2; ++r)
    for (int t = r + 1; t < n_l2; ++t)
      if (Nq[r] == Nq[t]) return false;

  // ascending predicted darea of the shared grain; the last two stay
  float key[RING];
  for (int r = 0; r < n_l2; ++r) {
    key[r] = (Nq[r] >= 0 && Nq[r] < S.NG) ? yg0[Nq[r]] : 0.f;
    taken[r] = false;
  }
  const int n_events = max(n_l2 - 2, 0);
  for (int o = 0; o < n_events; ++o) {
    int best = -1;
    for (int r = 0; r < n_l2; ++r)
      if (!taken[r] && (best < 0 || key[r] < key[best])) best = r;
    taken[best] = true;
    events[o] = L2[best];
  }
  switch_events(S, events, RING, n_events, gs, forces);
  return true;
}

// Delete every grain left with one or two live ring edges (at most
// `budget`, ascending id). dropped[budget] receives the deleted ids.
__device__ __noinline__ void two_sided_cleanup(Ed& S, int num_grains,
                                               int budget, int* dropped) {
  for (int g = threadIdx.x; g < num_grains; g += NT) S.cnt[g] = 0;
  __syncthreads();
  for (int i = threadIdx.x; i < S.EQ; i += NT) {
    const int v = S.pq1[i];
    if (v >= 0 && v < num_grains) atomicAdd(&S.cnt[v], 1);
  }
  __syncthreads();
  first_k([&](int g) { return S.cnt[g] > 0 && S.cnt[g] <= 2; },
          num_grains, budget, -1);
  int targets[KMAX];
  for (int k = 0; k < budget; ++k) targets[k] = s_fk[k];
  for (int k = 0; k < budget; ++k) {
    const int t = targets[k];
    dropped[k] = (t >= 0 && delete_grain(S, t)) ? t : -1;
  }
}

__global__ void __launch_bounds__(NT) editor_kernel(
    Ed S, const float* __restrict__ prob, const float* __restrict__ yg0,
    const int* __restrict__ ge, int GE, float threshold, int num_grains,
    int MS, int* ptr_io, int* sw, int* extra, int max_extra) {
  const int tid = threadIdx.x;
  S.ptr = *ptr_io;
  for (int i = tid; i < max_extra; i += NT) extra[i] = -1;
  __syncthreads();
  int n_extra = 0;
  auto put_extra = [&](const int* vals, int n) {
    for (int i = 0; i < n; ++i) {
      if (vals[i] < 0) continue;
      if (tid == 0 && n_extra < max_extra) extra[n_extra] = vals[i];
      ++n_extra;
    }
  };

  // candidate switches: live u<v columns over threshold, by descending
  // probability, ties by column; each round takes the next in that order
  int L1[MAX_MS];
  int n1 = 0;
  float lp = 2.f;
  int li = -1;
  for (int k = 0; k < MS; ++k) {
    float bp = -1.f;
    int bi = BIG;
    for (int c = tid; c < S.EP; c += NT) {
      const float p = prob[c];
      const int u = S.pp0[c], v = S.pp1[c];
      if (p > threshold && u < v && u >= 0 && before(lp, li, p, c) &&
          before(p, c, bp, bi)) {
        bp = p;
        bi = c;
      }
    }
    block_best(bp, bi);
    if (bi >= BIG) break;
    L1[n1++] = bi;
    lp = bp;
    li = bi;
  }
  for (int k = n1; k < MS; ++k) L1[k] = -1;

  // grain eliminations
  const int ts_budget = max(MAX_TWOSIDED, GE);
  int ev[RING], forces[2 * RING], dropped[KMAX];
  for (int i = 0; i < GE; ++i) {
    const int g = ge[i];
    if (g < 0) continue;
    const bool ok = ring_collapse(S, g, yg0, ev, forces);
    put_extra(forces, 2 * RING);
    if (!ok) continue;
    delete_grain(S, g);
    for (int k = 0; k < 2 * RING; ++k)
      if (forces[k] >= 0) delete_grain(S, forces[k]);
    for (int k = 0; k < RING; ++k)
      for (int m = 0; m < MS; ++m)
        if (ev[k] >= 0 && L1[m] == ev[k]) L1[m] = -1;
    two_sided_cleanup(S, num_grains, ts_budget, dropped);
  }

  // pending switches whose column is still live, in order
  int L1c[MAX_MS];
  int n_sw = 0;
  for (int m = 0; m < MS; ++m)
    if (L1[m] >= 0 && gi(S.pp0, S.EP, L1[m]) >= 0) L1c[n_sw++] = L1[m];
  for (int m = n_sw; m < MS; ++m) L1c[m] = -1;
  int fs[2 * MAX_MS];
  switch_events(S, L1c, MS, n_sw, -1, fs);
  put_extra(fs, 2 * MS);
  if (tid == 0) {
    for (int m = 0; m < MS; ++m) {
      sw[2 * m] = L1c[m] >= 0 ? gi(S.pp0, S.EP, L1c[m]) : -1;
      sw[2 * m + 1] = L1c[m] >= 0 ? gi(S.pp1, S.EP, L1c[m]) : -1;
    }
  }
  two_sided_cleanup(S, num_grains, ts_budget, dropped);
  put_extra(dropped, ts_budget);
  if (tid == 0) *ptr_io = S.ptr;
}

}  // namespace

extern "C" {

const char* ggnn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// One span's edit in place on the state arrays (pp [2, EP], pq [2, EQ],
// xj [NJ, xs], yj [NJ, 2], mg [NG], mj [NJ], ptr [1]); writes sw
// [MS, 2] and extra [max_extra]. cnt is [num_grains] scratch.
int editor_update(int* pp, int EP, int* pq, int EQ, float* xj, int NJ,
                  int xs, float* yj, int* mg, int* mj, int NG,
                  const float* prob, const float* yg0, const int* ge, int GE,
                  float threshold, int num_grains, int MS, int* ptr, int* sw,
                  int* extra, int* cnt, int max_extra, void* stream) {
  const int ts_budget = GE > MAX_TWOSIDED ? GE : MAX_TWOSIDED;
  if (MS < 0 || MS > MAX_MS || GE < 0 || GE > MAX_GE || ts_budget > KMAX ||
      xs < 8 || EP < 1 || EQ < 1 || num_grains > NG)
    return cudaErrorInvalidValue;
  Ed S{pp, pp + EP, EP, pq, pq + EQ, EQ, xj, NJ, xs, yj, mg, NG, mj, cnt, 0};
  cudaGetLastError();   // clear any stale error
  editor_kernel<<<1, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      S, prob, yg0, ge, GE, threshold, num_grains, MS, ptr, sw, extra,
      max_extra);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
