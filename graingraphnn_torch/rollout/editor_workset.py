"""Working-set topology editor: the span's edit run on the small subset of
columns its events can touch, then scattered back into the full arrays.

The editor's per-event cost is a scan over the whole edge arrays, but a
span's edit only reads the neighbourhoods of its candidate events. This
module:

  1. computes the footprint, a hop closure over the junction-grain
     incidence of the candidate switch edges, the elimination grains and
     the grains already two-sided, with whole-array mask expansions;
  2. compacts the footprint's columns, in column order, into a mini COO
     pair of fixed capacity; node arrays stay whole, so node ids never
     remap and the editor's node writes are final;
  3. runs the unmodified update_jit (rollout.topology_jit: the editor
     kernel on the card) on the mini state, its two-sided cleanup limited
     to the footprint's grains;
  4. scatters the edited columns, and the appended reconnection columns,
     back into the full arrays.

Exactness: the mini edit is the same algorithm on the same data in the
same order, provided every column an event chain reads lies in the
working set. A guard shell (the closure's last layer) detects a cascade
that ran deeper than the closure; then, and when the working set is
invalid (capacity, too many candidates, a live last column), the edit
runs again on the full arrays. That second edit is a host branch on the
flag, made in the open: the result is the full editor's, never the mini
one's.

Fill-sentinel invariant: the editor's first-k queries fill missing
indices with the LAST column, whose values guard logic may read. The mini
arrays keep a dead last column; exactness against the full editor also
needs the full state's last E_pq and E_pp columns dead
(init_device_state pads both), which build_workset checks.
"""

from __future__ import annotations

import dataclasses

import torch

from . import topology_jit as tj

NEG = -1e30
SLACK = 128   # free E_pp columns kept behind the selected ones for appends


def _scatter_or(mask, idx, hit):
    """mask[idx] |= hit, indices past the end dropped. mask [N] bool."""
    n = mask.shape[0]
    tgt = torch.where(hit, idx.long(), n)
    out = torch.cat([mask, mask.new_zeros(1)]).to(torch.int32)
    out.scatter_reduce_(0, tgt.clamp(0, n), hit.to(torch.int32), "amax")
    return out[:n] > 0


def _take(mask, idx):
    return mask[idx.long()]


def _closure(E_pp, E_pq, seed_j, seed_g, rounds: int = 3, reduce=None):
    """Hop closure over the junction-grain incidence. Each round adds the
    grains of the junction set, their ring junctions, and the jj
    neighbours of those. `reduce` (None on one device) merges each
    sub-step's mask across column shards. Returns (fp_j, fp_g, shell_j,
    shell_g): the shells are the nodes the LAST round added."""
    reduce = reduce or (lambda m: m)
    live_q = (E_pq[0] >= 0) & (E_pq[1] >= 0)
    live_p = (E_pp[0] >= 0) & (E_pp[1] >= 0)
    qs = torch.where(live_q, E_pq[0], 0)
    qd = torch.where(live_q, E_pq[1], 0)
    pa = torch.where(live_p, E_pp[0], 0)
    pb = torch.where(live_p, E_pp[1], 0)

    fp_j, fp_g = seed_j, seed_g
    prev_j, prev_g = fp_j, fp_g
    for _ in range(rounds):
        prev_j, prev_g = fp_j, fp_g
        fp_g = reduce(_scatter_or(fp_g, qd, live_q & _take(fp_j, qs)))
        fp_j = reduce(_scatter_or(fp_j, qs, live_q & _take(fp_g, qd)))
        fp_j = reduce(_scatter_or(fp_j, pb, live_p & _take(fp_j, pa)))
    return fp_j, fp_g, fp_j & ~prev_j, fp_g & ~prev_g


def _compact_cols(sel, cap: int):
    """The ids of the selected columns, in order, in [cap] (-1 pad).
    Returns (cols, count, overflow)."""
    E = sel.shape[0]
    pos = torch.cumsum(sel.to(torch.int64), 0) - 1
    count = sel.sum().to(torch.int32)
    tgt = torch.where(sel & (pos < cap), pos, cap)
    cols = torch.full((cap + 1,), -1, dtype=torch.int32, device=sel.device)
    cols.scatter_(0, tgt, torch.arange(E, dtype=torch.int32,
                                       device=sel.device))
    return cols[:cap], count, count > cap


def _columns(E, cols):
    """E[:, cols] with -1 where cols < 0."""
    vals = E[:, torch.where(cols >= 0, cols, 0).long()]
    return torch.where(cols[None, :] >= 0, vals, -1).to(E.dtype)


@dataclasses.dataclass
class WorksetInfo:
    q_cols: torch.Tensor     # [WQ - 1] full E_pq column of each mini column
    p_cols: torch.Tensor     # [WP] full E_pp column of each mini column
    n_p: torch.Tensor        # selected live E_pp columns (mini append base)
    fallback: torch.Tensor   # bool: the working set is invalid
    shell_j: torch.Tensor
    shell_g: torch.Tensor
    fp_g: torch.Tensor       # the mini editor's cleanup mask


def seeds(E_pp, E_pq, prob, grain_events, threshold, NJ: int, NG: int):
    """Closure seeds of one span: the endpoints of the candidate switches,
    the elimination grains, and the grains already two-sided. Returns
    (seed_j, seed_g_events, counts, n_cand): the two-sided term needs the
    ring counts of every column, which a column shard has only in part,
    so the caller adds it."""
    cand = (prob > threshold) & (E_pp[0] < E_pp[1]) & (E_pp[0] >= 0)
    seed_j = torch.zeros(NJ, dtype=torch.bool, device=E_pp.device)
    seed_j = _scatter_or(seed_j, torch.where(cand, E_pp[0], NJ), cand)
    seed_j = _scatter_or(seed_j, torch.where(cand, E_pp[1], NJ), cand)
    ge_ok = grain_events >= 0
    seed_g = torch.zeros(NG, dtype=torch.bool, device=E_pp.device)
    seed_g = _scatter_or(seed_g, torch.where(ge_ok, grain_events, NG), ge_ok)
    live_q = (E_pq[0] >= 0) & (E_pq[1] >= 0)
    counts = torch.zeros(NG + 1, dtype=torch.int32, device=E_pq.device)
    counts.index_add_(0, torch.where(live_q, E_pq[1], NG).long(),
                      torch.ones_like(E_pq[1]))
    return seed_j, seed_g, counts[:NG], cand.sum()


def selection(E_pp, E_pq, fp_j, fp_g):
    """The columns of the footprint: (sel_q [EQ], sel_p [EP])."""
    live_q = (E_pq[0] >= 0) & (E_pq[1] >= 0)
    qs = torch.where(live_q, E_pq[0], 0)
    qd = torch.where(live_q, E_pq[1], 0)
    sel_q = live_q & (_take(fp_j, qs) | _take(fp_g, qd))
    live_p = (E_pp[0] >= 0) & (E_pp[1] >= 0)
    pa = torch.where(live_p, E_pp[0], 0)
    pb = torch.where(live_p, E_pp[1], 0)
    sel_p = live_p & (_take(fp_j, pa) | _take(fp_j, pb))
    return sel_q, sel_p


def build_workset(state: tj.TopoState, edge_logits, grain_events, threshold,
                  *, wq: int, wp: int, max_cand: int = 96, rounds: int = 3):
    """Footprint and column selection of one span's update. Returns (info,
    mini_state, mini_logits)."""
    E_pp, E_pq = state.E_pp, state.E_pq
    NJ, NG = state.mask_j.shape[0], state.mask_g.shape[0]
    EP, EQ = E_pp.shape[1], E_pq.shape[1]
    prob = torch.sigmoid(edge_logits.float())
    seed_j, seed_g, counts, n_cand = seeds(E_pp, E_pq, prob, grain_events,
                                           threshold, NJ, NG)
    seed_g = seed_g | ((counts > 0) & (counts <= 2))
    fp_j, fp_g, shell_j, shell_g = _closure(E_pp, E_pq, seed_j, seed_g,
                                            rounds)
    sel_q, sel_p = selection(E_pp, E_pq, fp_j, fp_g)
    q_cols, _n_q, of_q = _compact_cols(sel_q, wq - 1)   # a dead last column
    p_cols, n_p, of_p = _compact_cols(sel_p, wp)
    of_p = of_p | (n_p > wp - SLACK)    # append slack behind the selection
    tail_dead = (E_pq[0, EQ - 1] < 0) & (E_pp[0, EP - 1] < 0)
    fallback = of_q | of_p | (n_cand > max_cand) | ~tail_dead

    mini_q = torch.full((2, wq), -1, dtype=torch.int32, device=E_pq.device)
    mini_q[:, : wq - 1] = _columns(E_pq, q_cols)
    mini_p = _columns(E_pp, p_cols)
    mini_logits = torch.where(
        p_cols >= 0, edge_logits[torch.where(p_cols >= 0, p_cols, 0).long()],
        torch.full_like(p_cols, NEG, dtype=edge_logits.dtype))
    mini_state = dataclasses.replace(state, E_pp=mini_p, E_pq=mini_q,
                                     append_ptr=n_p)
    info = WorksetInfo(q_cols=q_cols, p_cols=p_cols, n_p=n_p,
                       fallback=fallback, shell_j=shell_j, shell_g=shell_g,
                       fp_g=fp_g)
    return info, mini_state, mini_logits


def shell_touched(mask_j, mask_g, mst: tj.TopoState, shell_j, shell_g,
                  wp: int):
    """Did the mini edit mst change a guard-shell node of the masks it
    started from, or append past wp (the mini arrays drop such
    columns)?"""
    return ((shell_j & (mask_j != mst.mask_j)).any()
            | (shell_g & (mask_g != mst.mask_g)).any()
            | (mst.append_ptr > wp))


def appended(mst: tj.TopoState, n_p, wp: int):
    """The mini edit's appended columns [2, wp] (lane k < n_app holds the
    k-th) and their count n_app. Reads past the mini arrays (a working
    set over its capacity, whose result the caller discards) clamp to the
    last column, as JAX's gathers do."""
    n_app = mst.append_ptr - n_p
    lanes = torch.arange(wp, dtype=torch.int32, device=n_p.device)
    src = torch.where(lanes < n_app, n_p + lanes, 0)
    return mst.E_pp[:, src.clamp(0, mst.E_pp.shape[1] - 1).long()], n_app, \
        lanes


def _put(E, tgt, vals):
    """E[:, tgt] = vals for tgt < E.shape[1]; others dropped."""
    W = E.shape[1]
    ok = tgt < W
    out = torch.cat([E, E.new_full((2, 1), -1)], dim=1)
    out[:, torch.where(ok, tgt, W).long()] = vals
    return out[:, :W]


def workset_update(state: tj.TopoState, edge_logits, grain_events, y_grain,
                   threshold, num_grains: int, *,
                   max_switch: int = tj.MAX_SWITCH, wq: int = 1024,
                   wp: int = 1024, rounds: int = 3):
    """update_jit's result, edited on the working set. Where the working
    set is invalid or its guard shell was touched, the edit runs again on
    the full arrays (a host branch on the flag). Returns (state,
    switching, extra)."""
    info, mini_state, mini_logits = build_workset(
        state, edge_logits, grain_events, threshold, wq=wq, wp=wp,
        rounds=rounds)
    if not bool(info.fallback):
        mst, switching, extra = tj.update_jit(
            mini_state, mini_logits, grain_events, y_grain, threshold,
            num_grains, max_switch=max_switch, cleanup_g_mask=info.fp_g)
        if not bool(shell_touched(state.mask_j, state.mask_g, mst,
                                  info.shell_j, info.shell_g, wp)):
            EP, EQ = state.E_pp.shape[1], state.E_pq.shape[1]
            E_pq = _put(state.E_pq, torch.where(info.q_cols >= 0,
                                                info.q_cols, EQ),
                        mst.E_pq[:, : wq - 1])
            E_pp = _put(state.E_pp, torch.where(info.p_cols >= 0,
                                                info.p_cols, EP),
                        mst.E_pp[:, :wp])
            # appended reconnection columns: mini [n_p, ptr) -> full cursor
            vals, n_app, lanes = appended(mst, info.n_p, wp)
            E_pp = _put(E_pp, torch.where(lanes < n_app,
                                          state.append_ptr + lanes, EP),
                        vals)
            over = state.append_ptr + n_app > EP
            out = dataclasses.replace(
                state, E_pp=E_pp, E_pq=E_pq, xj=mst.xj, mask_g=mst.mask_g,
                mask_j=mst.mask_j,
                append_ptr=torch.where(over, EP + 1, state.append_ptr
                                       + n_app).to(torch.int32))
            return out, switching, extra
    return tj.update_jit(state, edge_logits, grain_events, y_grain,
                         threshold, num_grains, max_switch=max_switch)
