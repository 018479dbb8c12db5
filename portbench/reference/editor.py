"""The topology editor of one span of one lane, as plain sequential
PyTorch: a frozen copy of the port's editor semantics (the JAX package's
fused editor core), with the static span's settings only (no melt-pool
windows, every grain cleaned up).

It applies, in order: grain eliminations (ring collapse by neighbor
switches, deletion of the grain and of any grain the collapse forces out,
two-sided cleanup), then the pending neighbor switches in descending
probability, then a final two-sided cleanup. Deleted edges become -1
sentinels; the reconnection edge of a deleted grain is appended at the
carried cursor `ptr`, so pending event indices stay valid. Integer state
and events are exact; float positions are computed in float32 with the
same operations in the same order as the kernel, which the port builds
with -fmad=false for that reason.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

JOINT_SCALE = 5.0   # the joint targets' scaling (positions move by y / 5)
MAX_TWOSIDED = 8    # two-sided cleanup budget of a pass

RING = 16           # junction-ring capacity of one grain
F32 = np.float32


@dataclasses.dataclass
class EditorState:
    """Mutable editor state: 1-D views, edited in place."""
    pp0: torch.Tensor   # [EP] int32  E_pp row 0 (source joint)
    pp1: torch.Tensor   # [EP] int32  E_pp row 1 (destination joint)
    pq0: torch.Tensor   # [EQ] int32  E_pq row 0 (joint)
    pq1: torch.Tensor   # [EQ] int32  E_pq row 1 (grain)
    posx: torch.Tensor  # [NJ] float32
    posy: torch.Tensor
    gx: torch.Tensor    # [NJ] float32 previous displacement (xj[:, 6:8])
    gy: torch.Tensor
    yjx: torch.Tensor   # [NJ] float32 predicted displacement
    yjy: torch.Tensor
    mg: torch.Tensor    # [NG] int32
    mj: torch.Tensor    # [NJ] int32
    ptr: int            # next free E_pp column


def _gi(vec, i: int) -> int:
    """vec[i] as an int; 0 outside [0, N)."""
    return int(vec[i]) if 0 <= i < vec.shape[0] else 0


def _gf(vec, i: int):
    """vec[i] as a float32 scalar; 0 outside [0, N)."""
    return F32(vec[i].item()) if 0 <= i < vec.shape[0] else F32(0.0)


def _put(vec, i: int, val):
    """vec[i] = val; dropped outside [0, N)."""
    if 0 <= i < vec.shape[0]:
        vec[i] = float(val) if isinstance(val, np.floating) else val


def _first_k(cond, k: int, fill: int) -> List[int]:
    """First k ascending indices where cond holds, `fill` beyond."""
    idx = torch.nonzero(cond).flatten()[:k].tolist()
    return idx + [fill] * (k - len(idx))


def _first2_of3(b):
    """First two true positions of three flags, 0 where absent (the
    fixed-size nonzero of the JAX code)."""
    f = 0 if b[0] else (1 if b[1] else (2 if b[2] else 0))
    s = 1 if (b[1] and f < 1) else (2 if (b[2] and f < 2) else 0)
    return f, s


def _wrap_s(p, pc):
    """Image of p nearest pc on the unit torus, in float32."""
    rel = p - pc
    return (p - F32(1.0 if rel > 0.5 else 0.0)) + F32(1.0 if rel < -0.5 else 0.0)


def _order_asc(keys) -> List[int]:
    """Stable ascending argsort of a short list."""
    return sorted(range(len(keys)), key=lambda r: keys[r])


def _switch_one(st: EditorState, e: int, events, pos: int, n_events: int,
                elim_grain: int):
    """One neighbor switch of jj edge column e. Returns the grains it
    forces out (-1 when none)."""
    EP, EQ = st.pp0.shape[0], st.pq0.shape[0]
    p1, p2 = _gi(st.pp0, e), _gi(st.pp1, e)
    valid = e >= 0 and p1 >= 0 and p2 >= 0
    p1s, p2s = (p1, p2) if valid else (0, 0)

    # grain rings of both endpoints (3 each)
    a = _first_k(st.pq0 == p1s, 3, EQ - 1)
    b = _first_k(st.pq0 == p2s, 3, EQ - 1)
    q1 = [_gi(st.pq1, i) for i in a]
    q2 = [_gi(st.pq1, i) for i in b]
    # other joint neighbors of both endpoints (2 each)
    c = _first_k((st.pp0 == p1s) & (st.pp1 != p2s), 2, EP - 1)
    d = _first_k((st.pp0 == p2s) & (st.pp1 != p1s), 2, EP - 1)

    in2 = [q in q2 for q in q1]
    in1 = [q in q1 for q in q2]
    valid = valid and sum(in2) == 2 and sum(in1) == 2

    # shrink pair keeps p1-ring order; expand = the two non-shared grains
    sh0, sh1 = _first2_of3(in2)
    shrink_q1, shrink_q2 = q1[sh0], q1[sh1]
    expand_q1 = q1[_first2_of3([not v for v in in2])[0]]
    expand_q2 = q2[_first2_of3([not v for v in in1])[0]]
    qs10, qs11 = a[sh0], a[sh1]
    m0 = q2.index(shrink_q1) if shrink_q1 in q2 else 0
    m1 = q2.index(shrink_q2) if shrink_q2 in q2 else 0
    qs20, qs21 = b[m0], b[m1]

    # joint-neighbor ordering: index 0 borders shrink_q1
    fn1, fn2 = _gi(st.pp1, c[0]), _gi(st.pp1, d[0])
    border1 = bool(((st.pq0 == fn1) & (st.pq1 == shrink_q1)).any())
    border2 = bool(((st.pq0 == fn2) & (st.pq1 == shrink_q1)).any())
    pn10, pn11 = (c[0], c[1]) if border1 else (c[1], c[0])
    pn20, pn21 = (d[0], d[1]) if border2 else (d[1], d[0])
    sq1_p1, sq2_p1 = _gi(st.pp1, pn10), _gi(st.pp1, pn11)
    sq1_p2, sq2_p2 = _gi(st.pp1, pn20), _gi(st.pp1, pn21)

    degenerate = sq1_p1 == sq1_p2 or sq2_p1 == sq2_p2
    valid = valid and (elim_grain >= 0 or not degenerate)
    force1 = (shrink_q1 if valid and sq1_p1 == sq1_p2
              and shrink_q1 != elim_grain else -1)
    force2 = (shrink_q2 if valid and sq2_p1 == sq2_p2
              and shrink_q2 != elim_grain else -1)

    # periodic midpoint reposition
    x1x, x1y = _gf(st.posx, p1s), _gf(st.posy, p1s)
    x2x, x2y = _gf(st.posx, p2s), _gf(st.posy, p2s)
    cx = F32(0.5) * (x1x + _wrap_s(x2x, x1x))
    cy = F32(0.5) * (x1y + _wrap_s(x2y, x1y))
    n2x, n2y = _wrap_s(cx, x2x), _wrap_s(cy, x2y)

    # lookahead over the remaining events (this one included)
    nxt = set()
    for k in range(pos, min(n_events, len(events))):
        if events[k] >= 0:
            nxt.add(_gi(st.pp0, events[k]))
            nxt.add(_gi(st.pp1, events[k]))
    h0, h1 = sq1_p2 in nxt, sq2_p2 in nxt
    h2, h3 = sq1_p1 in nxt, sq2_p1 in nxt
    swap = True
    if h0 and not h1:
        swap = False
    if h1 and not h0:
        swap = True
    if h2 and not h3:
        swap = True
    if h3 and not h2:
        swap = False
    if swap:
        qs10, qs11, qs20, qs21 = qs11, qs10, qs21, qs20
        pn10, pn11, pn20, pn21 = pn11, pn10, pn21, pn20
    sq1_p2_f = sq2_p2 if swap else sq1_p2
    sq2_p1_f = sq1_p1 if swap else sq2_p1

    if valid:
        _put(st.posx, p1s, cx)
        _put(st.posx, p2s, n2x)
        _put(st.posy, p1s, cy)
        _put(st.posy, p2s, n2y)
        _put(st.pq1, qs11, expand_q2)
        _put(st.pq1, qs20, expand_q1)
        _put(st.pp0, pn11, p2s)
        _put(st.pp0, pn20, p1s)
        mm1 = (st.pp0 == sq1_p2_f) & (st.pp1 == p2s)
        st.pp1[mm1] = p1s
        mm2 = (st.pp0 == sq2_p1_f) & (st.pp1 == p1s)
        st.pp1[mm2] = p2s
    return force1, force2


def switch_events(st: EditorState, events: List[int], n_events: int,
                  elim_grain: int) -> List[int]:
    """Roll back the predicted displacement of every joint the events
    touch, run the switches in order, then
    zero those joints' predicted displacement and gradients. Returns the
    forced grains [2 * len(events)] (-1 fills)."""
    K = len(events)
    NJ = st.posx.shape[0]
    touched = torch.zeros(NJ, dtype=torch.bool)
    for k in range(min(n_events, K)):
        if events[k] >= 0:
            for v in (_gi(st.pp0, events[k]), _gi(st.pp1, events[k])):
                if 0 <= v < NJ:
                    touched[v] = True
    zero = torch.zeros_like(st.posx)
    st.posx += torch.where(touched, -st.yjx / JOINT_SCALE, zero)
    st.posy += torch.where(touched, -st.yjy / JOINT_SCALE, zero)

    forces = [-1] * (2 * K)
    for i in range(min(n_events, K)):
        forces[2 * i], forces[2 * i + 1] = _switch_one(
            st, events[i], events, i, n_events, elim_grain)

    for v in (st.yjx, st.yjy, st.gx, st.gy):
        v[touched] = 0.0
    return forces


def delete_grain(st: EditorState, grain: int) -> bool:
    """Delete a two-sided grain: its two junctions merge into one new jj
    edge pair appended at `ptr`. Returns whether the grain was deleted."""
    EP, EQ = st.pp0.shape[0], st.pq0.shape[0]
    g = grain if grain >= 0 else 0
    ring = st.pq1 == g
    r0, r1 = _first_k(ring, 2, EQ - 1)
    valid = grain >= 0 and int(ring.sum()) == 2
    p1 = _gi(st.pq0, r0) if valid else 0
    p2 = _gi(st.pq0, r1) if valid else 0
    cnd1 = (st.pp0 == p1) & (st.pp1 != p2)
    cnd2 = (st.pp0 == p2) & (st.pp1 != p1)
    (i1,) = _first_k(cnd1, 1, EP - 1)
    (i2,) = _first_k(cnd2, 1, EP - 1)
    valid = valid and bool(cnd1.any()) and bool(cnd2.any())
    if not valid:
        return False
    np1, np2 = _gi(st.pp1, i1), _gi(st.pp1, i2)
    _put(st.pp0, st.ptr, np1)
    _put(st.pp0, st.ptr + 1, np2)
    _put(st.pp1, st.ptr, np2)
    _put(st.pp1, st.ptr + 1, np1)
    st.ptr += 2
    _put(st.mg, g, 0)
    _put(st.mj, p1, 0)
    _put(st.mj, p2, 0)
    kill_q = (st.pq1 == g) | (st.pq0 == p1) | (st.pq0 == p2)
    st.pq0[kill_q] = -1
    st.pq1[kill_q] = -1
    kill_p = ((st.pp0 == p1) | (st.pp1 == p1)
              | (st.pp0 == p2) | (st.pp1 == p2))
    st.pp0[kill_p] = -1
    st.pp1[kill_p] = -1
    return True


def _ring_collapse(st: EditorState, g: int, y_g0):
    """Collapse grain g's junction ring by switching all but two of its
    ring edges, in ascending predicted darea of the neighbor across each
    edge. Returns (ok, events [RING], forces [2 * RING])."""
    EP, EQ = st.pp0.shape[0], st.pq0.shape[0]
    skip = (False, [-1] * RING, [-1] * (2 * RING))
    gs = g if g >= 0 else 0
    ring_cond = st.pq1 == gs
    ring_n = int(ring_cond.sum())
    if not (g >= 0 and 0 < ring_n <= RING):
        return skip
    ring_idx = _first_k(ring_cond, RING, EQ - 1)
    Np = torch.tensor([_gi(st.pq0, i) for i in ring_idx[:ring_n]],
                      dtype=st.pp0.dtype)

    # ring edges: jj columns u<v with both ends on the ring
    src_hit = st.pp0[None, :] == Np[:, None]          # [ring_n, EP]
    dst_hit = st.pp1[None, :] == Np[:, None]
    cand_col = src_hit.any(0) & dst_hit.any(0) & (st.pp0 < st.pp1)
    src_slot = torch.where(cand_col, src_hit.int().argmax(0), 0)
    dst_slot = torch.where(cand_col, dst_hit.int().argmax(0), 0)
    i_slot = torch.minimum(src_slot, dst_slot)
    j_slot = torch.maximum(src_slot, dst_slot)
    comb_rank = (i_slot * (2 * RING - i_slot - 1) // 2
                 + (j_slot - i_slot - 1))

    n_l2 = int(cand_col.sum())
    if n_l2 != ring_n:
        return skip
    cols = _first_k(cand_col, RING, EP - 1)
    # ring_n = n_l2 <= RING: every listed column is a found ring edge
    order_c = _order_asc([int(comb_rank[cols[r]]) for r in range(n_l2)])
    L2 = [cols[o] for o in order_c]

    # the grain shared across each ring edge
    Nq = []
    for col in L2:
        ep1, ep2 = _gi(st.pp0, col), _gi(st.pp1, col)
        n1 = _first_k((st.pq0 == ep1) & (st.pq1 != gs), 2, EQ - 1)
        n2 = _first_k((st.pq0 == ep2) & (st.pq1 != gs), 2, EQ - 1)
        nq1 = [_gi(st.pq1, i) for i in n1]
        nq2 = [_gi(st.pq1, i) for i in n2]
        first_in = nq1[0] in nq2
        if not (first_in or nq1[1] in nq2):
            return skip
        Nq.append(nq1[0] if first_in else nq1[1])
    if len(set(Nq)) != len(Nq):
        return skip

    # ascending predicted darea of the shared grain; the last two stay
    keys = [_gf(y_g0, q) for q in Nq]
    L2_sorted = [L2[o] for o in _order_asc(keys)]
    n_events = max(n_l2 - 2, 0)
    events = (L2_sorted[:n_events] + [-1] * RING)[:RING]
    forces = switch_events(st, events, n_events, gs)
    return True, events, forces


def _two_sided_cleanup(st: EditorState, num_grains: int, budget: int):
    """Delete every grain left with one or two live ring edges (at most
    `budget`, ascending id). Returns the deleted ids [budget], -1
    fills."""
    live = st.pq1 >= 0
    cnt = torch.bincount(st.pq1[live].long(), minlength=num_grains)
    cnt = cnt[:num_grains]
    bad = (cnt > 0) & (cnt <= 2)
    targets = _first_k(bad, budget, -1)
    return [t if t >= 0 and delete_grain(st, t) else -1 for t in targets]


def editor_core(st: EditorState, y_g0, prob, grain_events: List[int],
                threshold, num_grains: int, max_switch: int):
    """The whole edit of one span, in place on `st`. prob [EP] float32 is
    the switch probability of each jj column; threshold a float32 scalar.
    Returns (sw0, sw1 [max_switch] switched edge endpoints, extra
    [max_extra] forced and cleaned-up grain ids), -1 fills."""
    MS = max_switch
    GE = len(grain_events)
    max_extra = 2 * GE * (RING + 1) + 2 * MS
    ts_budget = max(MAX_TWOSIDED, GE)

    # candidate switches: live u<v columns over threshold, by descending
    # probability, ties by column
    cand = (prob > threshold) & (st.pp0 < st.pp1) & (st.pp0 >= 0)
    idx = torch.nonzero(cand).flatten()
    order = torch.sort(prob[idx], descending=True, stable=True).indices
    L1 = idx[order][:MS].tolist()

    extra: List[int] = []

    def put_extra(vals):
        extra.extend(v for v in vals if v >= 0)

    for g in grain_events:
        if g < 0:
            continue
        okc, L2ev, forces = _ring_collapse(st, g, y_g0)
        put_extra(forces)
        if okc:
            delete_grain(st, g)
            for fv in forces:
                if fv >= 0:
                    delete_grain(st, fv)
            collapsed = {v for v in L2ev if v >= 0}
            L1 = [v for v in L1 if v not in collapsed]
            _two_sided_cleanup(st, num_grains, ts_budget)

    # pending switches whose column is still live, in order
    L1c = [v for v in L1 if _gi(st.pp0, v) >= 0]
    events = L1c + [-1] * (MS - len(L1c))
    put_extra(switch_events(st, events, len(L1c), -1))
    sw0 = [_gi(st.pp0, v) for v in L1c] + [-1] * (MS - len(L1c))
    sw1 = [_gi(st.pp1, v) for v in L1c] + [-1] * (MS - len(L1c))
    put_extra(_two_sided_cleanup(st, num_grains, ts_budget))
    extra = (extra + [-1] * max_extra)[:max_extra]
    return sw0, sw1, extra


def edit_lane(E_pp, E_pq, xj, y_joint, mask_g, mask_j, ptr: int, prob,
              grain_events: List[int], y_g0, threshold, num_grains: int,
              max_switch: int):
    """The edit of one lane on copies of its CPU tensors: E_pp, E_pq [2, E]
    int32, xj [NJ, F] float32 (positions 0:2, previous displacement 6:8),
    y_joint [NJ, 2], masks [NG] / [NJ] int32, the append cursor, prob
    [EP], the grain events, y_g0 [NG] (predicted darea). Returns a dict of
    the edited E_pp, E_pq, xj, mask_g, mask_j, ptr, switching
    [max_switch, 2] and extra."""
    E_pp, E_pq = E_pp.clone(), E_pq.clone()
    xj, yj = xj.clone(), y_joint.clone()
    mg, mj = mask_g.clone(), mask_j.clone()
    st = EditorState(
        pp0=E_pp[0], pp1=E_pp[1], pq0=E_pq[0], pq1=E_pq[1],
        posx=xj[:, 0], posy=xj[:, 1], gx=xj[:, 6], gy=xj[:, 7],
        yjx=yj[:, 0], yjy=yj[:, 1], mg=mg, mj=mj, ptr=int(ptr))
    sw0, sw1, extra = editor_core(st, y_g0, prob, grain_events,
                                  np.float32(threshold), num_grains,
                                  max_switch)
    return {"E_pp": E_pp, "E_pq": E_pq, "xj": xj, "mask_g": mg,
            "mask_j": mj, "ptr": st.ptr,
            "switching": torch.tensor([sw0, sw1], dtype=torch.int32).T,
            "extra": torch.tensor(extra, dtype=torch.int32)}
