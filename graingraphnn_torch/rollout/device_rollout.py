"""Device-resident rollout span: one span runs entirely on the card, with no
host transfer inside the span loop.

    build ELL + edge lengths   (make_sample: sort-based, fixed shapes)
      -> regressor + classifier forward      (models.grain_nn)
      -> moving melt pool window + taper     (melt_stage, optional)
      -> feature integration + z advance     (integrate_stage)
      -> elimination candidates              (elim_candidates)
      -> topology editor, one kernel launch  (kernels.editor_fused)
      -> nucleation                          (topology_jit.nucleate_jit,
                                              optional)
      -> E_pp compaction + grain centers     (finalize_stage)

Every array keeps a fixed shape with -1 sentinels for dead columns, so the
loop makes no data-dependent host decision; the capacity flags stay on the
device and are checked once after the loop (check_capacity).

Each stage is a span of utils.profiling (graingnn.build, .span, .sample,
.forward, .post with .integrate, .elim, .edit and .finalize, and
.capacity_read): a flag check while nothing records. In a recorded build
the capacity read also reads the build's counters (COUNTERS), reduced on
the device, and files them under the build.

The ELL tables come from a stable sort of the COO lists every span or,
where the caller asks for them (init_device_state(incremental=True), the
JAX package's path past 16384 pull columns), from persistent column
tables (pull_cols, push_cols, connect_cols) that finalize_stage keeps
current by re-ranking only the destinations an edit touched
(update_ell_cols). Both give the same slots: the k-th live edge into a
destination by ascending column. The sort is the default: on the H100 it
is the cheaper of the two at every size measured, since the tables'
fallback rebuild is computed every span to keep the span free of host
syncs.

Grain centers are the masked mean of each grain's junction ring unwrapped
into the periodic image of the previous center, taken mod 1; arithmetic is
float32. Scope: periodic boundary; the static or the moving melt pool;
generate-mode nucleation into padded rows and columns
(init_device_state(nucleation_slack)).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..graph import schema
from ..graph.state import GraphSample, round_up
from ..kernels import editor_fused
from ..utils import profiling
from . import topology_jit as tj

TRAIN_FRAMES = 120
NEG = -1e30
# destinations a span's edit may touch before finalize_stage takes the
# column tables' fallback rebuild (maintained_cols's t_max)
TOUCH_MAX = 256
# a build's counters, reduced on the device over its stacked aux while a
# profiling.recording() is in progress (build_counters)
COUNTERS = ("switches", "eliminations", "extra_events",
            "elim_saturated_spans", "jj_overflow_spans", "jg_overflow_spans",
            "ring_high", "pp_headroom")
_FORWARD = {m: profiling.span("graingnn.forward", model=m)
            for m in ("regressor", "classifier")}


@dataclasses.dataclass
class DeviceRolloutState:
    xg: torch.Tensor      # [NG, GRAIN_DIM] float32
    xj: torch.Tensor      # [NJ, JOINT_DIM] float32
    E_pp: torch.Tensor    # [2, EP] int32 directed jj COO, -1 sentinels;
                          # live columns compacted to the front each span
    E_pq: torch.Tensor    # [2, EQ] int32 pull COO (joint, grain)
    mask_g: torch.Tensor  # [NG] int32
    mask_j: torch.Tensor  # [NJ] int32
    n_pp: torch.Tensor    # [] int32 live E_pp columns (append cursor)
    # persistent ELL column tables (None: rebuilt by a sort every span):
    # cols[d, k] = COO column of the k-th live edge into d, -1 dead
    pull_cols: Optional[torch.Tensor] = None     # [NG, ring] over E_pq row 1
    push_cols: Optional[torch.Tensor] = None     # [NJ, 3] over E_pq row 0
    connect_cols: Optional[torch.Tensor] = None  # [NJ, 3] over E_pp row 1
    # nucleation cursors (None without nucleation slack): next grain row,
    # next joint row, next free E_pq column
    n_g: Optional[torch.Tensor] = None
    n_j: Optional[torch.Tensor] = None
    n_pq: Optional[torch.Tensor] = None

    def map(self, fn) -> "DeviceRolloutState":
        """A copy with fn applied to every tensor field."""
        return tj.map_fields(self, fn)


def _wrap(rel):
    """Minimum-image displacement on the unit torus."""
    return rel - (rel > 0.5).to(rel.dtype) + (rel < -0.5).to(rel.dtype)


def _ell_slots(src, dst, num_dst: int, max_deg: int):
    """Slots of a padded COO list [E] (or B lanes' lists [B, E]) in a
    destination-major ELL: the rank of each live edge among the live edges
    into its destination by ascending column, from one stable sort (a
    lane's destinations offset by lane * num_dst). Returns (order, flat,
    ok, overflow): sorted position -> flat column, its flat ELL index
    (past the lanes' num_dst * max_deg where it has none), whether it has
    a slot, and whether a destination's live degree exceeds max_deg (per
    lane)."""
    lead = src.shape[:-1]
    B, E = lead.numel(), src.shape[-1]
    live = (src >= 0) & (dst >= 0)
    if lead:
        lane = torch.arange(B, dtype=torch.int32, device=src.device)
        dst = dst + lane.reshape(lead + (1,)) * num_dst
    n = B * num_dst
    dstk = torch.where(live, dst, n).to(torch.int32).reshape(-1)
    ds, order = torch.sort(dstk, stable=True)
    first = torch.searchsorted(ds, ds, side="left")
    slot = torch.arange(B * E, device=src.device) - first
    ok = (ds < n) & (slot < max_deg)
    flat = torch.where(ok, ds.long() * max_deg + slot, n * max_deg)
    if not lead:
        return order, flat, ok, ok.sum() < live.sum()
    n_ok = torch.zeros(B + 1, dtype=torch.int64, device=src.device)
    n_ok.scatter_add_(0, torch.where(ok, ds // num_dst, B).long(),
                      ok.long())
    return order, flat, ok, n_ok[:B].reshape(lead) < live.sum(-1)


def _scatter_ell(flat, vals, num_dst: int, max_deg: int, fill, dtype,
                 lead=()):
    n = torch.Size(lead).numel() * num_dst
    out = torch.full((n * max_deg + 1,), fill, dtype=dtype,
                     device=flat.device)
    return out.index_put_((flat,), vals.to(dtype))[:-1].reshape(
        *lead, num_dst, max_deg)


def build_ell(src, dst, attr, num_dst: int, max_deg: int):
    """Destination-major ELL from a padded COO list (slots by _ell_slots),
    of one lane or of each of B lanes (a leading axis on every input and
    output). Returns (nbr [(B,) D, K] int32, len [(B,) D, K] float32,
    mask [(B,) D, K] float32, overflow [(B,)]): overflow flags a
    destination whose live degree exceeds max_deg (its extra edges are
    dropped)."""
    lead = src.shape[:-1]
    order, flat, ok, overflow = _ell_slots(src, dst, num_dst, max_deg)
    nbr = _scatter_ell(flat, src.reshape(-1)[order], num_dst, max_deg, 0,
                       torch.int32, lead)
    length = _scatter_ell(flat, attr.reshape(-1)[order], num_dst, max_deg,
                          0, torch.float32, lead)
    mask = _scatter_ell(flat, ok, num_dst, max_deg, 0, torch.float32, lead)
    return nbr, length, mask, overflow


def build_pull_cols(src, dst, num_dst: int, ring: int):
    """The ELL's column table from scratch: cols[(b,) d, k] = the COO
    column of the k-th live edge into d by ascending column (build_ell's
    slot order), -1 dead. Returns (cols [(B,) num_dst, ring] int32,
    overflow [(B,)])."""
    lead = src.shape[:-1]
    order, flat, _, overflow = _ell_slots(src, dst, num_dst, ring)
    if lead:
        order = torch.remainder(order, src.shape[-1])
    return (_scatter_ell(flat, order, num_dst, ring, -1, torch.int32, lead),
            overflow)


def _take(src, idx):
    """src[idx] of one lane, or src[b][idx[b]] of each lane b: src [(B,) E],
    idx [(B,) ...] int64."""
    return torch.gather(src, -1, idx.reshape(*src.shape[:-1], -1)).reshape(
        idx.shape)


def ell_from_cols(cols, src, attr):
    """The ELL through a current column table (one lane or B): neighbor
    ids and edge attributes gathered at the stored columns. Equals
    build_ell's (nbr, len, mask)."""
    live = cols >= 0
    c = torch.where(live, cols, 0).long()
    nbr = torch.where(live, _take(src, c), 0).to(torch.int32)
    length = torch.where(live, _take(attr, c), 0.0).to(torch.float32)
    return nbr, length, live.to(torch.float32)


def update_ell_cols(cols, E_old, E_new, dst_row: int, *, t_max: int = 64):
    """Keep a column table current across an edit, of one lane or of each
    of B lanes (a leading axis on every input and output, and a touch
    budget per lane). Only destinations of a
    changed COO column (before or after the edit) can change their slots:
    up to t_max of them are re-ranked over the post-edit list, each slot
    k found by a binary search for the first column where the row's
    running count of live matches reaches k + 1. dst_row is the COO row
    that holds the ELL destination: 1 for pull (E_pq) and connect (E_pp),
    0 for push (E_pq).

    Returns (cols, touch_over, deg_over): more than t_max destinations
    touched (those past t_max kept stale slots; maintained_cols falls back
    to a rebuild), and a touched destination's live degree past the
    table's width (a capacity bust)."""
    *lead, num_dst, ring = cols.shape
    lead = tuple(lead)
    dev = cols.device
    changed = torch.any(E_old != E_new, dim=-2)
    live_old = (E_old[..., 0, :] >= 0) & (E_old[..., 1, :] >= 0)
    live_new = (E_new[..., 0, :] >= 0) & (E_new[..., 1, :] >= 0)
    d_new_row = E_new[..., dst_row, :]
    d_old = torch.where(changed & live_old, E_old[..., dst_row, :],
                        num_dst).long()
    d_new = torch.where(changed & live_new, d_new_row, num_dst).long()
    flag = torch.zeros(lead + (num_dst + 1,), dtype=torch.bool, device=dev)
    flag = flag.scatter_(-1, d_old, True).scatter_(-1, d_new, True)
    flag = flag[..., :num_dst]
    n_touched = flag.sum(-1)

    # the touched destinations, compacted to the front of [t_max]
    pos = torch.cumsum(flag.to(torch.int32), -1) - 1
    slot = torch.where(flag & (pos < t_max), pos, t_max).long()
    touched = torch.full(lead + (t_max + 1,), -1, dtype=torch.int32,
                         device=dev)
    touched.scatter_(-1, slot, torch.arange(
        num_dst, dtype=torch.int32, device=dev).expand(lead + (num_dst,)))
    touched = touched[..., :t_max]

    match = (live_new[..., None, :]
             & (d_new_row[..., None, :] == touched[..., :, None])
             & (touched[..., :, None] >= 0))                 # [t_max, E]
    cum = torch.cumsum(match.to(torch.int32), dim=-1, dtype=torch.int32)
    deg = cum[..., -1]
    deg_over = (deg > ring).any(-1)
    kk = torch.arange(1, ring + 1, dtype=torch.int32, device=dev)
    rows = torch.searchsorted(
        cum, kk.expand(lead + (t_max, ring)).contiguous(),
        side="left").to(torch.int32)
    rows = torch.where(kk <= deg[..., None], rows, -1)

    out = torch.cat([cols, cols.new_full(lead + (1, ring), -1)], dim=-2)
    dst = torch.where(touched >= 0, touched, num_dst).long()
    out.scatter_(-2, dst[..., None].expand(lead + (t_max, ring)), rows)
    return out[..., :num_dst, :], n_touched > t_max, deg_over


def maintained_cols(cols, E_old, E_new, dst_row: int, *, t_max: int = 64):
    """update_ell_cols, falling back to a from-scratch build when the edit
    touched more than t_max destinations. Both are computed and the flag
    selects on the device, so the span makes no host sync. Returns (cols,
    overflow): a destination's live degree past the table's width."""
    num_dst, ring = cols.shape[-2:]
    cols2, touch_over, deg_over = update_ell_cols(
        cols, E_old, E_new, dst_row, t_max=t_max)
    rebuilt, rb_over = build_pull_cols(E_new[..., 1 - dst_row, :],
                                       E_new[..., dst_row, :], num_dst, ring)
    return (torch.where(touch_over[..., None, None], rebuilt, cols2),
            torch.where(touch_over, rb_over, deg_over))


def update_pull_cols(cols, E_pq_old, E_pq_new, *, t_max: int = 64):
    """update_ell_cols over E_pq (destination row 1) with no fallback: the
    touch-budget bust is folded into the returned overflow flag."""
    cols2, touch_over, deg_over = update_ell_cols(
        cols, E_pq_old, E_pq_new, 1, t_max=t_max)
    return cols2, touch_over | deg_over


def _coo_lengths(pos_src, pos_dst, src, dst):
    """Periodic edge lengths of a padded COO list."""
    s = torch.where(src >= 0, src, 0).long()
    d = torch.where(dst >= 0, dst, 0).long()
    rel = _wrap(pos_src[s] - pos_dst[d])
    return torch.sqrt(torch.sum(rel * rel, dim=-1))


@profiling.span("graingnn.sample")
def make_sample(state: DeviceRolloutState, ring: int = tj.RING_MAX):
    """The padded GraphSample of the forward, its ELL tables read through
    the state's column tables where it keeps them. Returns (sample, flags):
    flags {"ring_overflow", "jg_overflow", "jj_overflow"}, [] bool each, a
    destination of the pull, push or connect table past its width (its
    extra edges dropped); a table read through column tables was checked
    when they were last updated, and its flag is False."""
    xg, xj = state.xg, state.xj
    NG, NJ = xg.shape[0], xj.shape[0]
    if state.pull_cols is not None and state.pull_cols.shape[-1] != ring:
        raise ValueError(
            f"pull_cols built with ring={state.pull_cols.shape[-1]} but "
            f"sample requested ring={ring}")
    pos_g, pos_j = xg[:, :2], xj[:, :2]
    pq_len = _coo_lengths(pos_j, pos_g, state.E_pq[0], state.E_pq[1])
    pp_len = _coo_lengths(pos_j, pos_j, state.E_pp[0], state.E_pp[1])
    checked = None          # the flag of a table read through its columns
    if any(c is not None for c in (state.pull_cols, state.push_cols,
                                   state.connect_cols)):
        checked = torch.zeros((), dtype=torch.bool, device=xg.device)
    if state.push_cols is not None:
        push_nbr, push_len, push_mask = ell_from_cols(
            state.push_cols, state.E_pq[1], pq_len)
        jg_overflow = checked
    else:
        push_nbr, push_len, push_mask, jg_overflow = build_ell(
            state.E_pq[1], state.E_pq[0], pq_len, NJ, schema.JG_DEGREE)
    if state.connect_cols is not None:
        connect_nbr, connect_len, connect_mask = ell_from_cols(
            state.connect_cols, state.E_pp[0], pp_len)
        jj_overflow = checked
    else:
        connect_nbr, connect_len, connect_mask, jj_overflow = build_ell(
            state.E_pp[0], state.E_pp[1], pp_len, NJ, schema.JJ_DEGREE)
    if state.pull_cols is not None:
        pull_nbr, pull_len, pull_mask = ell_from_cols(
            state.pull_cols, state.E_pq[0], pq_len)
        overflow = checked
    else:
        pull_nbr, pull_len, pull_mask, overflow = build_ell(
            state.E_pq[0], state.E_pq[1], pq_len, NG, ring)
    jj_live = (state.E_pp[0] >= 0).to(torch.float32)
    sample = GraphSample(
        grain_x=xg, joint_x=xj,
        grain_mask=state.mask_g.to(torch.float32),
        joint_mask=state.mask_j.to(torch.float32),
        push_nbr=push_nbr, push_len=push_len, push_mask=push_mask,
        connect_nbr=connect_nbr, connect_len=connect_len,
        connect_mask=connect_mask,
        pull_nbr=pull_nbr, pull_len=pull_len, pull_mask=pull_mask,
        jj_src=torch.clamp_min(state.E_pp[0], 0),
        jj_dst=torch.clamp_min(state.E_pp[1], 0),
        jj_len=pp_len * jj_live,
        jj_mask=jj_live,
    )
    return sample, {"ring_overflow": overflow, "jg_overflow": jg_overflow,
                    "jj_overflow": jj_overflow}


def _pallas_mode(pallas) -> str:
    """The conv precision of the rollout factories' `pallas` option, JAX's
    values: False, None and "fp32" take the fp32 kernels (JAX's XLA
    formulation and its fp32 Pallas conv, one precision class); True and
    "bf16" the bf16 kernels (JAX's fused Pallas conv at bf16 operands)."""
    if pallas in (False, None) or pallas == "fp32":
        return "fp32"
    if pallas is True or pallas == "bf16":
        return "bf16"
    raise ValueError(f"pallas mode {pallas!r}")


def forward_stage(regressor, classifier, state, ring, precision="fp32"):
    """ELL rebuild + model forwards on the hand kernels of `precision`, in
    inference mode. Returns (sample, y_r, y_c, flags), flags make_sample's
    overflow flags."""
    sample, flags = make_sample(state, ring)
    with torch.inference_mode():
        with _FORWARD["regressor"]:
            y_r = regressor(sample, kernels=True, precision=precision)
        with _FORWARD["classifier"]:
            y_c = classifier(sample, kernels=True, precision=precision)
    return sample, y_r, y_c, flags


@profiling.span("graingnn.integrate")
def integrate_stage(state, pred_j, pred_g, span):
    """Feature integration + z advance, of one lane or of each of B lanes
    (a leading axis), each clamped at its own row 0's z. Returns (xg,
    xj)."""
    xg, xj = state.xg.clone(), state.xj.clone()
    xj[..., :2] += pred_j / schema.TARGET_SCALING["joint"]
    xg[..., schema.GRAIN_AREA_COL] += (pred_g[..., 0]
                                       / schema.TARGET_SCALING["grain"])
    xg[..., schema.GRAIN_EXTRAV_COL] = pred_g[..., 1]
    xj[..., 6:8] = pred_j
    xg[..., schema.GRAIN_DAREA_COL] = pred_g[..., 0]
    dz = span / (TRAIN_FRAMES + 1)
    zmax = TRAIN_FRAMES / (TRAIN_FRAMES + 1)
    clamp = (xg[..., :1, 2] + dz) > zmax
    xg[..., 2] = torch.where(clamp, torch.full_like(xg[..., 2], zmax),
                             xg[..., 2] + dz)
    xj[..., 2] = torch.where(clamp, torch.full_like(xj[..., 2], zmax),
                             xj[..., 2] + dz)
    return xg, xj


@profiling.span("graingnn.elim")
def elim_candidates(state, area, r_threshold, max_elim: int = tj.MAX_ELIM,
                    active_g=None):
    """Live grains under the area threshold, ascending predicted area, of
    one lane or of each of B lanes; with the melt pool's grain window
    active_g [NG] bool, only active ones. Returns (ge [(B,) max_elim]
    int32, -1 pad; n_candidates [(B,)])."""
    cond = (state.mask_g > 0) & (area < r_threshold)
    if active_g is not None:
        cond = cond & active_g
    key = torch.where(cond, area, torch.full_like(area, float("inf")))
    order = torch.argsort(key, dim=-1, stable=True)
    n_cand = torch.isfinite(key).sum(-1)
    ge = torch.where(torch.isfinite(torch.gather(key, -1, order)),
                     order.to(torch.int32), -1)
    return ge[..., :max_elim], n_cand


@profiling.span("graingnn.edit")
def edit_stage(state, xg, xj, pred_j, pred_g, edge_logits, ge, c_threshold,
               max_switch: int = tj.MAX_SWITCH, active_g=None,
               active_j=None):
    """The span's topology edit in one editor launch (one lane, or B lanes
    at once), gated by the melt pool's windows where given. Returns
    (tstate, switching, extra)."""
    jj_live = state.E_pp[..., 0, :] >= 0
    logits = torch.where(jj_live, edge_logits, torch.full_like(edge_logits, NEG))
    tstate = tj.TopoState(
        E_pp=state.E_pp, E_pq=state.E_pq, xj=xj, y_joint=pred_j,
        mask_g=state.mask_g, mask_j=state.mask_j, append_ptr=state.n_pp,
        active_j=active_j,
    )
    return editor_fused.update_fused(
        tstate, logits, ge, pred_g, c_threshold, xg.shape[-2],
        max_switch=max_switch, active_g=active_g)


def melt_stage(state, pred_j, pred_g, melt_term, melt_left):
    """The moving melt pool's active window: predictions taper to zero
    outside the sliding window [melt_left, melt_left + win] (fully by
    + gap), y-displacements and darea scale by the melt front's curvature,
    and the nodes outside the window freeze (the returned windows gate the
    editor).

    melt_term: {r0, z0, win, gap, domain_factor (floats), offset_x [NJ]
    float32 (global-x offsets of patch-rescaled joints, 0 past n_off),
    n_off}; melt_left: [] float32. Returns (pred_j, pred_g, active_g [NG]
    bool, active_j [NJ] bool).

    As in the JAX package, a grain's x is its patch-local one. Unlike it,
    the curvature factor is taken only where the window is open: behind the
    window the JAX package multiplies a zero taper by r0 / curvature, which
    is 0 / 0 where the curvature line crosses zero, and the NaN spreads
    through the graph in the spans after."""
    r0, z0 = melt_term["r0"], melt_term["z0"]
    win, gap = melt_term["win"], melt_term["gap"]
    ml = melt_left
    mr = ml + win
    me = ml + win + gap

    def window(xc):
        near = torch.clamp((xc - me) / (mr - me), 0.0, 1.0)
        return torch.where(xc < ml, torch.zeros_like(near), near)

    def curvature(xc):
        return z0 + (r0 - z0) * (xc - ml) / (mr - ml)

    def behind_zero(aw, v):
        return torch.where(aw > 0, v, torch.zeros_like(v))

    # Python numbers enter divisions as tensors: CUDA multiplies by the
    # reciprocal of a Python divisor, and `float / tensor` is
    # `tensor.reciprocal() * float`; JAX and the CPU divide
    NJ = state.xj.shape[0]
    rowj = torch.arange(NJ, device=state.xj.device) < melt_term["n_off"]
    df = torch.full_like(state.xj[:1, 0], melt_term["domain_factor"])
    gx_j = (state.xj[:, 0] + melt_term["offset_x"]) / df
    aw_j = torch.where(rowj, window(gx_j), torch.zeros_like(gx_j))
    gx_g = state.xg[:, 0] / df
    aw_g = window(gx_g)
    pred_j = pred_j * aw_j[:, None]
    curv_j = curvature(gx_j)
    pred_j[:, 1] = pred_j[:, 1] * torch.where(
        rowj, behind_zero(aw_j, torch.full_like(curv_j, r0) / curv_j),
        torch.ones_like(gx_j))
    pred_g = pred_g.clone()
    pred_g[:, 0] = pred_g[:, 0] * behind_zero(
        aw_g, aw_g * r0 / curvature(gx_g))
    pred_g[:, 1] = pred_g[:, 1] * aw_g
    return pred_j, pred_g, aw_g > 0.9999, aw_j > 0.9999


def compact_stage(E_pp_in, return_perm: bool = False):
    """Stable partition of E_pp [(B,) 2, EP] (each lane on its own), live
    columns first (prefix sums and one scatter), so the append cursor
    never outgrows the capacity. Returns (E_pp, n_pp), and with
    return_perm also pos: pos[c] is the new column of old column c (live
    columns keep their order, so a column table stays valid through
    pos)."""
    livec = E_pp_in[..., 0, :] >= 0
    n_live = livec.sum(-1).to(torch.int32)
    c_live = torch.cumsum(livec.to(torch.int32), -1)
    c_dead = torch.cumsum((~livec).to(torch.int32), -1)
    pos = torch.where(livec, c_live - 1,
                      n_live[..., None] + c_dead - 1).long()
    out = torch.zeros_like(E_pp_in).scatter_(
        -1, pos[..., None, :].expand(E_pp_in.shape), E_pp_in)
    if return_perm:
        return out, n_live, pos
    return out, n_live


def _lane_rows(x, idx):
    """Rows x[idx] of one lane (x [N, F]), or x[b][idx[b]] of each lane b
    (x [B, N, F], idx [B, ...])."""
    if x.dim() == 2:
        return x[idx.long()]
    B, N = x.shape[:2]
    off = torch.arange(B, device=x.device).reshape(
        (B,) + (1,) * (idx.dim() - 1)) * N
    return x.reshape(B * N, -1)[idx.long() + off]


def centers_stage(xg, xj, E_pq, ring, pull_cols=None):
    """Grain centers from the post-edit junction rings (read through the
    post-edit pull_cols where the state keeps them), of one lane or of
    each of B lanes."""
    NG = xg.shape[-2]
    zeros = torch.zeros(E_pq[..., 0, :].shape, device=xg.device)
    if pull_cols is not None:
        nbr, _len, rmask = ell_from_cols(pull_cols, E_pq[..., 0, :], zeros)
    else:
        nbr, _len, rmask, _ = build_ell(E_pq[..., 0, :], E_pq[..., 1, :],
                                        zeros, NG, ring)
    ring_pos = _lane_rows(xj[..., :2], nbr)
    prev_c = xg[..., :2]
    unwrapped = prev_c[..., None, :] + _wrap(ring_pos - prev_c[..., None, :])
    cnt = rmask.sum(dim=-1)
    cmean = torch.sum(unwrapped * rmask[..., None], dim=-2) / torch.clamp_min(
        cnt, 1.0)[..., None]
    new_c = torch.where((cnt >= 2)[..., None], torch.remainder(cmean, 1.0),
                        prev_c)
    xg = xg.clone()
    xg[..., :2] = new_c
    return xg


@profiling.span("graingnn.finalize")
def finalize_stage(E_pp_old, E_pq_old, E_pp_new, E_pq_new, pull_cols,
                   push_cols, connect_cols, xg, xj, *, ring: int):
    """Post-edit finalize, of one lane or of each of B lanes: the column
    tables kept current across the edit (where the state keeps them, touch
    budget TOUCH_MAX a lane), stable E_pp compaction and grain centers.
    connect_cols is updated on the pre-compaction columns and then mapped
    through the compaction. Returns (E_pp, n_pp, pull_cols, push_cols,
    connect_cols, xg, overflow)."""
    overflow = torch.zeros((), dtype=torch.bool, device=xg.device)
    if pull_cols is not None:
        pull_cols, ov = maintained_cols(pull_cols, E_pq_old, E_pq_new, 1,
                                        t_max=TOUCH_MAX)
        overflow = overflow | ov
    if push_cols is not None:
        push_cols, ov = maintained_cols(push_cols, E_pq_old, E_pq_new, 0,
                                        t_max=TOUCH_MAX)
        overflow = overflow | ov
    if connect_cols is not None:
        connect_cols, ov = maintained_cols(connect_cols, E_pp_old, E_pp_new,
                                           1, t_max=TOUCH_MAX)
        overflow = overflow | ov
        E_pp, n_pp, perm = compact_stage(E_pp_new, return_perm=True)
        live = connect_cols >= 0
        connect_cols = torch.where(
            live, _take(perm, torch.where(live, connect_cols, 0).long()),
            -1).to(torch.int32)
    else:
        E_pp, n_pp = compact_stage(E_pp_new)
    xg = centers_stage(xg, xj, E_pq_new, ring, pull_cols=pull_cols)
    return E_pp, n_pp, pull_cols, push_cols, connect_cols, xg, overflow


def _span_aux(aux, sample, flags):
    """A span's aux with the sample's push and connect overflow flags, and
    while recording the span's largest live pull degree (ring_high)."""
    aux["jg_overflow"] = flags["jg_overflow"]
    aux["jj_overflow"] = flags["jj_overflow"]
    if profiling.recorder() is not None:
        aux["ring_high"] = sample.pull_mask.sum(-1).max()
    return aux


@profiling.span("graingnn.span")
def device_step(regressor, classifier, state: DeviceRolloutState, *,
                r_threshold: float = 1e-4, c_threshold: float = 0.6,
                span: int = 6, ring: int = tj.RING_MAX,
                max_elim: int = tj.MAX_ELIM, max_switch: int = tj.MAX_SWITCH,
                nuc_density_term: float = 0.0,
                nuc_rand=None, nuc_angles=None, melt_term=None,
                melt_left=None, pallas=False):
    """One rollout span. Returns (next_state, aux): aux holds the span's
    grain events, extra events, switching pairs, message-edge count, the
    editor's append cursor and capacity flags (jg_overflow, jj_overflow:
    the sample's push and connect tables, kept but not fatal), all on the
    device. nuc_density_term > 0 turns on nucleation with this span's draws
    nuc_rand [NJcap] and nuc_angles [MAX_NUC, 2]; melt_term turns on the
    moving melt pool at melt_left.
    pallas=True (or "bf16") runs the forwards on the bf16 kernels, JAX's
    pallas=True scan (_pallas_mode)."""
    sample, y_r, y_c, flags = forward_stage(regressor, classifier, state,
                                            ring, _pallas_mode(pallas))
    message_edges = (sample.push_mask.sum() + sample.pull_mask.sum()
                     + sample.connect_mask.sum())
    new_state, aux = post_forward_step(
        state, y_r, y_c, flags["ring_overflow"], message_edges,
        r_threshold=r_threshold, c_threshold=c_threshold, span=span,
        ring=ring, max_elim=max_elim, max_switch=max_switch,
        nuc_density_term=nuc_density_term, nuc_rand=nuc_rand,
        nuc_angles=nuc_angles, melt_term=melt_term, melt_left=melt_left)
    return new_state, _span_aux(aux, sample, flags)


@profiling.span("graingnn.post")
def post_forward_step(state: DeviceRolloutState, y_r, y_c, overflow,
                      message_edges, *, r_threshold: float = 1e-4,
                      c_threshold: float = 0.6, span: int = 6,
                      ring: int = tj.RING_MAX, max_elim: int = tj.MAX_ELIM,
                      max_switch: int = tj.MAX_SWITCH,
                      nuc_density_term: float = 0.0, nuc_rand=None,
                      nuc_angles=None, melt_term=None, melt_left=None):
    """The span after the forward: melt pool window, integrate, pick
    candidates, edit, nucleate, finalize. A state of B lanes (fields with
    a leading [B] axis, predictions [B, ...]) runs each stage over the
    lane axis and the editor once for all lanes; it takes static spans
    only, as JAX's batched scan does."""
    pred_j, pred_g = y_r["joint"], y_r["grain"]
    lanes = state.mask_g.shape[:-1]
    if lanes and (melt_term is not None or nuc_density_term > 0.0):
        raise ValueError("a state of B lanes runs static spans only: no "
                         "melt pool, no nucleation")
    active_g = active_j = None
    if melt_term is not None:
        pred_j, pred_g, active_g, active_j = melt_stage(
            state, pred_j, pred_g, melt_term, melt_left)
    xg, xj = integrate_stage(state, pred_j, pred_g, span)
    ge, n_cand = elim_candidates(state, y_r["grain_area"], r_threshold,
                                 max_elim, active_g=active_g)
    tstate, switching, extra = edit_stage(
        state, xg, xj, pred_j, pred_g, y_c["edge_event"], ge, c_threshold,
        max_switch, active_g=active_g, active_j=active_j)
    n_g, n_j, n_pq = state.n_g, state.n_j, state.n_pq
    nuc_overflow = torch.zeros(lanes, dtype=torch.bool, device=xg.device)
    if nuc_density_term > 0.0:
        if n_g is None or n_j is None or n_pq is None:
            raise ValueError("nucleation needs the cursors of "
                             "init_device_state(nucleation_slack=...)")
        # the rate's denominator is the live-joint count BEFORE the edit
        n_live = torch.clamp_min(state.mask_j.sum().to(torch.float32), 1.0)
        prob = torch.full_like(n_live, nuc_density_term) / n_live
        t2, xg, n_g, n_j, _ = tj.nucleate_jit(
            dataclasses.replace(tstate, q_ptr=n_pq), xg, n_g, n_j,
            nuc_rand, nuc_angles, prob)
        n_pq = t2.q_ptr
        nuc_overflow = ((n_g > state.xg.shape[0] - tj.MAX_NUC)
                        | (n_j > state.xj.shape[0] - 2 * tj.MAX_NUC)
                        | (n_pq > state.E_pq.shape[1] - 9 * tj.MAX_NUC))
        tstate = dataclasses.replace(t2, q_ptr=None)
    (E_pp, n_pp, pull_cols, push_cols, connect_cols, xg,
     ov_fin) = finalize_stage(
        state.E_pp, state.E_pq, tstate.E_pp, tstate.E_pq, state.pull_cols,
        state.push_cols, state.connect_cols, xg, tstate.xj, ring=ring)
    new_state = DeviceRolloutState(
        xg=xg, xj=tstate.xj, E_pp=E_pp, E_pq=tstate.E_pq,
        mask_g=tstate.mask_g, mask_j=tstate.mask_j, n_pp=n_pp,
        pull_cols=pull_cols, push_cols=push_cols, connect_cols=connect_cols,
        n_g=n_g, n_j=n_j, n_pq=n_pq)
    aux = {
        "grain_events": ge,
        "extra_events": extra,
        "switching": switching,
        "message_edges": message_edges,
        "ring_overflow": overflow | ov_fin,
        # the editor's append cursor, against the E_pp capacity
        "append_ptr": tstate.append_ptr,
        # the editor's appends past the capacity are dropped: fatal
        "pp_overflow": tstate.append_ptr > state.E_pp.shape[-1],
        # candidates past the budget wait for the next span
        "elim_saturated": n_cand > max_elim,
        # a nucleation cursor within MAX_NUC sites of its array's end: fatal
        "nuc_overflow": nuc_overflow,
    }
    return new_state, aux


def build_counters(aux: Dict[str, torch.Tensor], pp_cap: int):
    """A build's COUNTERS as one int64 vector on the device, from its spans'
    stacked aux (which holds ring_high, a recorded build): the switches,
    grain eliminations and extra events made (rows not -1), the spans where
    a lane's elimination candidates passed the budget or the sample's
    connect (jj) or push (jg) table dropped an edge, the largest live pull
    degree of any grain, and the least room left in E_pp (pp_cap less the
    editor's largest append cursor)."""
    spans = aux["message_edges"].shape[0]

    def spans_with(flag):
        return flag.reshape(spans, -1).any(-1).sum()

    return torch.stack([c.to(torch.int64) for c in (
        (aux["switching"][..., 0] >= 0).sum(),
        (aux["grain_events"] >= 0).sum(),
        (aux["extra_events"] >= 0).sum(),
        spans_with(aux["elim_saturated"]),
        spans_with(aux["jj_overflow"]),
        spans_with(aux["jg_overflow"]),
        aux["ring_high"].max(),
        pp_cap - aux["append_ptr"].max())])


@profiling.span("graingnn.capacity_read")
def check_capacity(aux: Dict[str, torch.Tensor], counters=None):
    """Raise if any span of a run dropped edges (ring or append capacity)
    or came within a nucleation site of the padded rows' end (never set
    without nucleation): its graph is corrupt. The flags are [n_steps] or,
    for B lanes, [n_steps, B]; the error names the first span (and its
    lane). One device-to-host read per flag for the whole run. counters, a
    recorded build's build_counters(), are read first, in one transfer, and
    filed under the build. jg_overflow and jj_overflow are not checked."""
    rec = profiling.recorder()
    if counters is not None and rec is not None:
        rec.count(dict(zip(COUNTERS, counters.tolist())))
    for flag in ("ring_overflow", "pp_overflow", "nuc_overflow"):
        hits = aux[flag].cpu().numpy()
        if hits.any():
            at = np.unravel_index(int(np.argmax(hits)), hits.shape)
            lane = f", lane {int(at[1])}" if len(at) > 1 else ""
            raise RuntimeError(
                f"rollout capacity bust: {flag} at span {int(at[0])}{lane}; "
                "raise `ring`/`pp_cap`/`nucleation_slack`")


def make_rollout(regressor, classifier, *, n_steps: int, **step_kw):
    """run(state, nuc_rand=None, nuc_angles=None, melt_lefts=None) ->
    (state, aux) over n_steps spans, aux stacked per span like a scan's
    output. With nucleation (step_kw nuc_density_term > 0) span i takes
    nuc_rand[i] ([n_steps, NJcap] draws) and nuc_angles[i] ([n_steps,
    MAX_NUC, 2]); with the moving melt pool (step_kw melt_term) it takes
    melt_lefts[i]. The loop runs without host sync; run() reads the
    capacity flags once after it and raises on a bust. step_kw pallas:
    device_step's (an unknown mode raises here)."""
    _pallas_mode(step_kw.get("pallas", False))
    ring = step_kw.get("ring", tj.RING_MAX)

    @profiling.span(profiling.BUILD, lanes=1)
    def run(state: DeviceRolloutState, nuc_rand=None, nuc_angles=None,
            melt_lefts=None):
        auxs = []
        for i in range(n_steps):
            state, aux = device_step(
                regressor, classifier, state,
                nuc_rand=None if nuc_rand is None else nuc_rand[i],
                nuc_angles=None if nuc_angles is None else nuc_angles[i],
                melt_left=None if melt_lefts is None else melt_lefts[i],
                **step_kw)
            auxs.append(aux)
        return state, _stacked_aux(auxs, state.E_pp.shape[-1], ring)

    return run


def _stacked_aux(auxs, pp_cap: int, ring: int):
    """The spans' aux on a leading span axis, its capacity flags checked;
    in a recorded build its counters (build_counters) read with them and
    filed beside the capacities they are read against."""
    aux = {k: torch.stack([a[k] for a in auxs]) for k in auxs[0]}
    rec = profiling.recorder()
    if rec is None:
        check_capacity(aux)
    else:
        rec.count({"ring": ring, "pp_cap": pp_cap})
        check_capacity(aux, build_counters(aux, pp_cap))
    return aux


# ---------------------------------------------------------------------------
# batched rollout: B independent lanes on one card
# ---------------------------------------------------------------------------

def _pad(a, n: int, dim: int, fill):
    """a padded with fill to size n along dim."""
    if a.shape[dim] == n:
        return a
    shape = list(a.shape)
    shape[dim] = n - a.shape[dim]
    return torch.cat([a, a.new_full(shape, fill)], dim)


def stack_states(states) -> DeviceRolloutState:
    """Pad independent single-lane states to common capacities and stack
    them on a leading lane axis, on the lanes' device: padded grain and
    joint rows are dead (mask 0), padded edge columns -1, n_pp becomes
    [B]. A lane's column ids stay valid under tail padding, so the column
    tables stack with a -1 row fill; they are None if any lane lacks them.
    Nucleation cursors are dropped (the batched span is static)."""
    NG = max(s.xg.shape[0] for s in states)
    NJ = max(s.xj.shape[0] for s in states)
    EP = max(s.E_pp.shape[1] for s in states)
    EQ = max(s.E_pq.shape[1] for s in states)

    def stack(field, n, dim, fill):
        return torch.stack([_pad(getattr(s, field), n, dim, fill)
                            for s in states])

    def stack_cols(field, n):
        if any(getattr(s, field) is None for s in states):
            return None
        return stack(field, n, 0, -1)

    return DeviceRolloutState(
        xg=stack("xg", NG, 0, 0.0), xj=stack("xj", NJ, 0, 0.0),
        E_pp=stack("E_pp", EP, 1, -1), E_pq=stack("E_pq", EQ, 1, -1),
        mask_g=stack("mask_g", NG, 0, 0), mask_j=stack("mask_j", NJ, 0, 0),
        n_pp=torch.stack([s.n_pp.reshape(()) for s in states]),
        pull_cols=stack_cols("pull_cols", NG),
        push_cols=stack_cols("push_cols", NJ),
        connect_cols=stack_cols("connect_cols", NJ))


def pack_states(states) -> DeviceRolloutState:
    """B independent single-lane states as ONE block-diagonal graph, for
    the single-lane make_rollout with max_elim = MAX_ELIM * B and
    max_switch = MAX_SWITCH * B: node ids offset per lane, E_pq
    concatenated, E_pp's live columns first (lane by lane) and the dead
    slack at the tail. The column tables shift by each lane's column
    offset; connect_cols maps through the live-first order (stable within
    a lane, so the slots are kept). Lanes never interact, but the editor's
    budgets and chains grow with B: the kernel takes MAX_MS switches and
    MAX_GE grain events, so on the card this fits B <= 2 only. Lanes share
    the z schedule (the z clamp reads row 0)."""
    g_off, j_off, q_off = [], [], []
    ng = nj = nq = 0
    for s in states:
        g_off.append(ng)
        j_off.append(nj)
        q_off.append(nq)
        ng += s.xg.shape[0]
        nj += s.xj.shape[0]
        nq += s.E_pq.shape[1]

    def shift(a, off):
        return torch.where(a >= 0, a + off, -1).to(torch.int32)

    pp_live, pp_dead, pq = [], [], []
    for s, jo, go in zip(states, j_off, g_off):
        live = s.E_pp[0] >= 0
        pp_live.append(s.E_pp[:, live] + jo)
        pp_dead.append(s.E_pp.new_full((2, int((~live).sum())), -1))
        qlive = s.E_pq[0] >= 0
        pq.append(torch.stack([torch.where(qlive, s.E_pq[0] + jo, -1),
                               torch.where(qlive, s.E_pq[1] + go, -1)]))
    n_pp = sum(c.shape[1] for c in pp_live)
    pull_cols = push_cols = connect_cols = None
    if all(s.pull_cols is not None and s.push_cols is not None
           and s.connect_cols is not None for s in states):
        pull_cols = torch.cat([shift(s.pull_cols, o)
                               for s, o in zip(states, q_off)])
        push_cols = torch.cat([shift(s.push_cols, o)
                               for s, o in zip(states, q_off)])
        parts, live_off = [], 0
        for s in states:
            live = s.E_pp[0] >= 0
            new_pos = torch.cumsum(live.to(torch.int32), 0) - 1 + live_off
            cc = s.connect_cols
            parts.append(torch.where(cc >= 0, new_pos[cc.clamp_min(0).long()],
                                     -1).to(torch.int32))
            live_off += int(live.sum())
        connect_cols = torch.cat(parts)
    return DeviceRolloutState(
        xg=torch.cat([s.xg for s in states]),
        xj=torch.cat([s.xj for s in states]),
        E_pp=torch.cat(pp_live + pp_dead, 1).to(torch.int32),
        E_pq=torch.cat(pq, 1).to(torch.int32),
        mask_g=torch.cat([s.mask_g for s in states]),
        mask_j=torch.cat([s.mask_j for s in states]),
        n_pp=torch.tensor(n_pp, dtype=torch.int32, device=states[0].xg.device),
        pull_cols=pull_cols, push_cols=push_cols, connect_cols=connect_cols)


@profiling.span("graingnn.sample")
def _pack_build_sample(state: DeviceRolloutState, ring: int = tj.RING_MAX):
    """The forward's sample of a [B, ...] state in the packed id space: the
    lanes' COO lists with node ids offset per lane (b * NG, b * NJ),
    concatenated, and one ELL build per table over all B * NJ or B * NG
    rows (the sort; column tables, where the lanes keep them, give the
    same slots). Returns (sample, flags, message edges [B]): flags as
    make_sample's, "ring_overflow" [B] (one flag for all lanes, broadcast,
    as JAX's), "jg_overflow" and "jj_overflow" [] (one flag for all
    lanes)."""
    B, NG = state.xg.shape[:2]
    NJ = state.xj.shape[1]
    dev = state.xg.device
    g_off = (torch.arange(B, dtype=torch.int32, device=dev) * NG)[:, None]
    j_off = (torch.arange(B, dtype=torch.int32, device=dev) * NJ)[:, None]
    E_pq, E_pp = state.E_pq, state.E_pp
    live_q = (E_pq[:, 0] >= 0) & (E_pq[:, 1] >= 0)
    pq_src = torch.where(live_q, E_pq[:, 0] + j_off, -1).reshape(-1)
    pq_dst = torch.where(live_q, E_pq[:, 1] + g_off, -1).reshape(-1)
    live_p = (E_pp[:, 0] >= 0) & (E_pp[:, 1] >= 0)
    pp_a = torch.where(live_p, E_pp[:, 0] + j_off, -1).reshape(-1)
    pp_b = torch.where(live_p, E_pp[:, 1] + j_off, -1).reshape(-1)

    xg = state.xg.reshape(B * NG, -1)
    xj = state.xj.reshape(B * NJ, -1)
    pos_g, pos_j = xg[:, :2], xj[:, :2]
    pq_len = _coo_lengths(pos_j, pos_g, pq_src, pq_dst)
    pp_len = _coo_lengths(pos_j, pos_j, pp_a, pp_b)
    push_nbr, push_len, push_mask, jg_overflow = build_ell(
        pq_dst, pq_src, pq_len, B * NJ, schema.JG_DEGREE)
    connect_nbr, connect_len, connect_mask, jj_overflow = build_ell(
        pp_a, pp_b, pp_len, B * NJ, schema.JJ_DEGREE)
    pull_nbr, pull_len, pull_mask, overflow = build_ell(
        pq_src, pq_dst, pq_len, B * NG, ring)
    jj_live = live_p.reshape(-1).to(torch.float32)
    sample = GraphSample(
        grain_x=xg, joint_x=xj,
        grain_mask=state.mask_g.reshape(-1).to(torch.float32),
        joint_mask=state.mask_j.reshape(-1).to(torch.float32),
        push_nbr=push_nbr, push_len=push_len, push_mask=push_mask,
        connect_nbr=connect_nbr, connect_len=connect_len,
        connect_mask=connect_mask,
        pull_nbr=pull_nbr, pull_len=pull_len, pull_mask=pull_mask,
        jj_src=torch.clamp_min(pp_a, 0), jj_dst=torch.clamp_min(pp_b, 0),
        jj_len=pp_len * jj_live, jj_mask=jj_live,
    )
    edges = (push_mask.reshape(B, -1).sum(-1)
             + pull_mask.reshape(B, -1).sum(-1)
             + connect_mask.reshape(B, -1).sum(-1))
    return sample, {"ring_overflow": overflow.expand(B),
                    "jg_overflow": jg_overflow,
                    "jj_overflow": jj_overflow}, edges


@profiling.span("graingnn.span")
def batched_step(regressor, classifier, state: DeviceRolloutState, *,
                 r_threshold: float = 1e-4, c_threshold: float = 0.6,
                 span: int = 6, ring: int = tj.RING_MAX, pallas=False):
    """One static span of B independent lanes (a stack_states state): the
    sample built once in the packed id space, ONE regressor and ONE
    classifier forward over all lanes on the hand kernels, the
    predictions reshaped to [B, ...], then the post-forward stages over
    the lane axis with one editor launch for all lanes (one block a lane,
    single-lane budgets). Returns (next_state, aux), every aux entry with
    a leading [B] axis. pallas as device_step's."""
    B, NG = state.xg.shape[:2]
    NJ = state.xj.shape[1]
    precision = _pallas_mode(pallas)
    sample, flags, edges = _pack_build_sample(state, ring)
    with torch.inference_mode():
        with _FORWARD["regressor"]:
            y_r = regressor(sample, kernels=True, precision=precision)
        with _FORWARD["classifier"]:
            y_c = classifier(sample, kernels=True, precision=precision)
        y_r = {"joint": y_r["joint"].reshape(B, NJ, -1),
               "grain": y_r["grain"].reshape(B, NG, -1),
               "grain_area": y_r["grain_area"].reshape(B, NG)}
        y_c = {"edge_event": y_c["edge_event"].reshape(B, -1)}
    new_state, aux = post_forward_step(
        state, y_r, y_c, flags["ring_overflow"], edges,
        r_threshold=r_threshold, c_threshold=c_threshold, span=span,
        ring=ring)
    return new_state, _span_aux(aux, sample, flags)


def make_rollout_batched(regressor, classifier, *, n_steps: int, **step_kw):
    """run(state) -> (state, aux) over n_steps static spans of B lanes
    (batched_step; step_kw: r_threshold, c_threshold, span, ring, pallas),
    aux [n_steps, B, ...] like a scan's output. The loop runs without host
    sync; run() reads the capacity flags once after it and raises on a
    bust, naming the span and the lane."""
    _pallas_mode(step_kw.get("pallas", False))
    ring = step_kw.get("ring", tj.RING_MAX)

    @profiling.span(profiling.BUILD)
    def run(state: DeviceRolloutState):
        rec = profiling.recorder()
        if rec is not None:
            rec.annotate(lanes=int(state.xg.shape[0]))
        auxs = []
        for _ in range(n_steps):
            state, aux = batched_step(regressor, classifier, state, **step_kw)
            auxs.append(aux)
        return state, _stacked_aux(auxs, state.E_pp.shape[-1], ring)

    return run


def _to_device(a, dtype, device):
    return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)


def _cols_np(src, dst, num_dst: int, cap: int, what: str) -> np.ndarray:
    """A column table on the host (numpy stable sort, any size); raises
    where a destination's live degree exceeds cap."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    live = (src >= 0) & (dst >= 0)
    cols = np.full((num_dst, cap), -1, np.int32)
    dstk = np.where(live, dst, num_dst)
    order = np.argsort(dstk, kind="stable")
    ds = dstk[order]
    slot = np.arange(len(ds)) - np.searchsorted(ds, ds, side="left")
    ok = (ds < num_dst) & (slot < cap)
    if (ds < num_dst).sum() != ok.sum():
        raise ValueError(f"init {what} bust: a destination exceeds "
                         f"capacity {cap}")
    cols[ds[ok], slot[ok]] = order[ok]
    return cols


def init_device_state(x: Dict[str, np.ndarray], edges: Dict[str, np.ndarray],
                      mask: Dict[str, np.ndarray], *,
                      pp_cap: Optional[int] = None, ring: int = tj.RING_MAX,
                      incremental: bool = False,
                      nucleation_slack: int = 0,
                      device="cuda") -> DeviceRolloutState:
    """Pack host arrays (x/edges/mask dicts of the rollout engine) into a
    padded state on `device`. The E_pp capacity defaults to the live count
    plus one span's edit slack, rounded to 128 columns; E_pq gets a dead
    tail column so first-k queries that come up short read -1.

    incremental=True seeds persistent column tables (pull_cols, push_cols,
    connect_cols; a capacity bust raises here) that each span keeps
    current, the JAX package's path past 16384 pull columns; False (the
    default) rebuilds the ELL tables by a sort every span. Both give the
    same slots.

    nucleation_slack > 0 makes room for that many nucleations: 6 E_pp and
    9 E_pq columns, one grain row and two joint rows each (dead pads), and
    seeds the cursors n_g, n_j and n_pq."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_device_state: no CUDA device; pass "
                           "device='cpu' to run the plain versions")
    connect = np.asarray(edges["connect"], np.int64)
    connect = connect[:, connect[0] >= 0]
    slack = 2 * (tj.MAX_ELIM * 3 + tj.MAX_TWOSIDED + 2) + 6 * nucleation_slack
    EP = pp_cap or round_up(connect.shape[1] + slack, 128)
    E_pp = np.full((2, EP), -1, np.int32)
    E_pp[:, : connect.shape[1]] = connect
    pull_in = np.asarray(edges["pull"], np.int64)
    EQ = round_up(pull_in.shape[1] + 1 + 9 * nucleation_slack, 128)
    pull = np.full((2, EQ), -1, np.int32)
    pull[:, : pull_in.shape[1]] = pull_in
    n_g0, n_j0 = len(x["grain"]), len(x["joint"])
    cursors = {}
    if nucleation_slack:
        def pad(a, n):
            a = np.asarray(a)
            out = np.zeros((a.shape[0] + n,) + a.shape[1:], a.dtype)
            out[: a.shape[0]] = a
            return out

        x = {"grain": pad(x["grain"], nucleation_slack),
             "joint": pad(x["joint"], 2 * nucleation_slack)}
        mask = {"grain": pad(np.asarray(mask["grain"]).reshape(-1),
                             nucleation_slack),
                "joint": pad(np.asarray(mask["joint"]).reshape(-1),
                             2 * nucleation_slack)}
        cursors = {k: torch.tensor(v, dtype=torch.int32, device=device)
                   for k, v in (("n_g", n_g0), ("n_j", n_j0),
                                ("n_pq", pull_in.shape[1]))}
    tables = {}
    if incremental:
        NG, NJ = len(x["grain"]), len(x["joint"])
        tables = {k: torch.from_numpy(v).to(device) for k, v in (
            ("pull_cols", _cols_np(pull[0], pull[1], NG, ring, "pull ring")),
            ("push_cols", _cols_np(pull[1], pull[0], NJ, schema.JG_DEGREE,
                                   "push deg")),
            ("connect_cols", _cols_np(E_pp[0], E_pp[1], NJ,
                                      schema.JJ_DEGREE, "connect deg")))}
    return DeviceRolloutState(
        xg=_to_device(x["grain"], torch.float32, device),
        xj=_to_device(x["joint"], torch.float32, device),
        E_pp=_to_device(E_pp, torch.int32, device),
        E_pq=_to_device(pull, torch.int32, device),
        mask_g=_to_device(np.asarray(mask["grain"]).reshape(-1), torch.int32,
                          device),
        mask_j=_to_device(np.asarray(mask["joint"]).reshape(-1), torch.int32,
                          device),
        n_pp=torch.tensor(connect.shape[1], dtype=torch.int32, device=device),
        **tables, **cursors,
    )


def state_from_heterograph(hg0, *, pp_cap: Optional[int] = None,
                           incremental: bool = False,
                           nucleation_slack: int = 0,
                           device="cuda") -> DeviceRolloutState:
    """The device state of a test-mode HeteroState, unscaled: its float32
    features, pull and connect COO lists and grain mask (every joint
    live)."""
    x = {"grain": np.asarray(hg0.feature_dicts["grain"], np.float32),
         "joint": np.asarray(hg0.feature_dicts["joint"], np.float32)}
    edges = {"pull": np.asarray(hg0.edge_index_dicts[schema.EDGE_TYPES[1]],
                                np.int64),
             "connect": np.asarray(
                 hg0.edge_index_dicts[schema.EDGE_TYPES[2]], np.int64)}
    mask = {"grain": np.asarray(hg0.mask["grain"], np.int64).reshape(-1),
            "joint": np.ones(len(x["joint"]), np.int64)}
    return init_device_state(x, edges, mask, pp_cap=pp_cap,
                             incremental=incremental,
                             nucleation_slack=nucleation_slack, device=device)
