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

Grain centers are the masked mean of each grain's junction ring unwrapped
into the periodic image of the previous center, taken mod 1; arithmetic is
float32. Scope: periodic boundary; the static or the moving melt pool;
generate-mode nucleation into padded rows and columns
(init_device_state(nucleation_slack)); ELL tables rebuilt from scratch
every span.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from ..graph import schema
from ..graph.state import GraphSample, round_up
from ..kernels import editor_fused
from . import topology_jit as tj

TRAIN_FRAMES = 120
NEG = -1e30


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


def build_ell(src, dst, attr, num_dst: int, max_deg: int):
    """Destination-major ELL from a padded COO list. The slot of an edge is
    its rank among the live edges into the same destination by ascending
    column, from a stable sort. Returns (nbr [D, K] int32, len [D, K]
    float32, mask [D, K] float32, overflow): overflow flags a destination
    whose live degree exceeds max_deg (its extra edges are dropped)."""
    E = src.shape[0]
    dev = src.device
    live = (src >= 0) & (dst >= 0)
    dstk = torch.where(live, dst, num_dst).to(torch.int32)
    ds, order = torch.sort(dstk, stable=True)
    first = torch.searchsorted(ds, ds, side="left")
    slot = torch.arange(E, device=dev) - first
    ok = (ds < num_dst) & (slot < max_deg)
    flat = torch.where(ok, ds.long() * max_deg + slot, num_dst * max_deg)
    size = num_dst * max_deg + 1

    def scatter(vals, dtype):
        out = torch.zeros(size, dtype=dtype, device=dev)
        return out.index_put_((flat,), vals.to(dtype))[:-1].reshape(
            num_dst, max_deg)

    nbr = scatter(src[order], torch.int32)
    length = scatter(attr[order], torch.float32)
    mask = scatter(ok, torch.float32)
    overflow = ok.sum() < live.sum()
    return nbr, length, mask, overflow


def _coo_lengths(pos_src, pos_dst, src, dst):
    """Periodic edge lengths of a padded COO list."""
    s = torch.where(src >= 0, src, 0).long()
    d = torch.where(dst >= 0, dst, 0).long()
    rel = _wrap(pos_src[s] - pos_dst[d])
    return torch.sqrt(torch.sum(rel * rel, dim=-1))


def make_sample(state: DeviceRolloutState, ring: int = tj.RING_MAX):
    """The padded GraphSample of the forward. Returns (sample,
    ring_overflow)."""
    xg, xj = state.xg, state.xj
    NG, NJ = xg.shape[0], xj.shape[0]
    pos_g, pos_j = xg[:, :2], xj[:, :2]
    pq_len = _coo_lengths(pos_j, pos_g, state.E_pq[0], state.E_pq[1])
    pp_len = _coo_lengths(pos_j, pos_j, state.E_pp[0], state.E_pp[1])
    push_nbr, push_len, push_mask, _ = build_ell(
        state.E_pq[1], state.E_pq[0], pq_len, NJ, schema.JG_DEGREE)
    connect_nbr, connect_len, connect_mask, _ = build_ell(
        state.E_pp[0], state.E_pp[1], pp_len, NJ, schema.JJ_DEGREE)
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
    return sample, overflow


def forward_stage(regressor, classifier, state, ring):
    """ELL rebuild + model forwards on the hand kernels, in inference mode.
    Returns (sample, y_r, y_c, ring_overflow)."""
    sample, overflow = make_sample(state, ring)
    with torch.inference_mode():
        y_r = regressor(sample, kernels=True)
        y_c = classifier(sample, kernels=True)
    return sample, y_r, y_c, overflow


def integrate_stage(state, pred_j, pred_g, span):
    """Feature integration + z advance. Returns (xg, xj)."""
    xg, xj = state.xg.clone(), state.xj.clone()
    xj[:, :2] += pred_j / schema.TARGET_SCALING["joint"]
    xg[:, schema.GRAIN_AREA_COL] += pred_g[:, 0] / schema.TARGET_SCALING["grain"]
    xg[:, schema.GRAIN_EXTRAV_COL] = pred_g[:, 1]
    xj[:, 6:8] = pred_j
    xg[:, schema.GRAIN_DAREA_COL] = pred_g[:, 0]
    dz = span / (TRAIN_FRAMES + 1)
    zmax = TRAIN_FRAMES / (TRAIN_FRAMES + 1)
    clamp = (xg[0, 2] + dz) > zmax
    xg[:, 2] = torch.where(clamp, torch.full_like(xg[:, 2], zmax), xg[:, 2] + dz)
    xj[:, 2] = torch.where(clamp, torch.full_like(xj[:, 2], zmax), xj[:, 2] + dz)
    return xg, xj


def elim_candidates(state, area, r_threshold, max_elim: int = tj.MAX_ELIM,
                    active_g=None):
    """Live grains under the area threshold, ascending predicted area; with
    the melt pool's grain window active_g [NG] bool, only active ones.
    Returns (ge [max_elim] int32, -1 pad; n_candidates)."""
    cond = (state.mask_g > 0) & (area < r_threshold)
    if active_g is not None:
        cond = cond & active_g
    key = torch.where(cond, area, torch.full_like(area, float("inf")))
    order = torch.argsort(key, stable=True)
    n_cand = torch.isfinite(key).sum()
    ge = torch.where(torch.isfinite(key[order]), order.to(torch.int32), -1)
    return ge[:max_elim], n_cand


def edit_stage(state, xg, xj, pred_j, pred_g, edge_logits, ge, c_threshold,
               max_switch: int = tj.MAX_SWITCH, active_g=None,
               active_j=None):
    """The span's topology edit in one editor launch, gated by the melt
    pool's windows where given. Returns (tstate, switching, extra)."""
    jj_live = state.E_pp[0] >= 0
    logits = torch.where(jj_live, edge_logits, torch.full_like(edge_logits, NEG))
    tstate = tj.TopoState(
        E_pp=state.E_pp, E_pq=state.E_pq, xj=xj, y_joint=pred_j,
        mask_g=state.mask_g, mask_j=state.mask_j, append_ptr=state.n_pp,
        active_j=active_j,
    )
    return editor_fused.update_fused(
        tstate, logits, ge, pred_g, c_threshold, xg.shape[0],
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


def compact_stage(E_pp_in):
    """Stable partition of E_pp, live columns first (prefix sums and one
    scatter), so the append cursor never outgrows the capacity. Returns
    (E_pp, n_pp)."""
    livec = E_pp_in[0] >= 0
    n_live = livec.sum().to(torch.int32)
    c_live = torch.cumsum(livec.to(torch.int32), 0)
    c_dead = torch.cumsum((~livec).to(torch.int32), 0)
    pos = torch.where(livec, c_live - 1, n_live + c_dead - 1).long()
    out = torch.zeros_like(E_pp_in)
    out[:, pos] = E_pp_in
    return out, n_live


def centers_stage(xg, xj, E_pq, ring):
    """Grain centers from the post-edit junction rings."""
    NG = xg.shape[0]
    nbr, _len, rmask, _ = build_ell(
        E_pq[0], E_pq[1], torch.zeros(E_pq.shape[1], device=xg.device),
        NG, ring)
    ring_pos = xj[nbr.long(), :2]
    prev_c = xg[:, :2]
    unwrapped = prev_c[:, None, :] + _wrap(ring_pos - prev_c[:, None, :])
    cnt = rmask.sum(dim=1)
    cmean = torch.sum(unwrapped * rmask[..., None], dim=1) / torch.clamp_min(
        cnt, 1.0)[:, None]
    new_c = torch.where((cnt >= 2)[:, None], torch.remainder(cmean, 1.0),
                        prev_c)
    xg = xg.clone()
    xg[:, :2] = new_c
    return xg


def finalize_stage(E_pp_new, E_pq_new, xg, xj, *, ring: int):
    """Post-edit finalize: stable E_pp compaction and grain centers.
    Returns (E_pp, n_pp, xg)."""
    E_pp, n_pp = compact_stage(E_pp_new)
    xg = centers_stage(xg, xj, E_pq_new, ring)
    return E_pp, n_pp, xg


def device_step(regressor, classifier, state: DeviceRolloutState, *,
                r_threshold: float = 1e-4, c_threshold: float = 0.6,
                span: int = 6, ring: int = tj.RING_MAX,
                max_elim: int = tj.MAX_ELIM, max_switch: int = tj.MAX_SWITCH,
                nuc_density_term: float = 0.0, nuc_rand=None,
                nuc_angles=None, melt_term=None, melt_left=None):
    """One rollout span. Returns (next_state, aux): aux holds the span's
    grain events, extra events, switching pairs, message-edge count and
    capacity flags, all on the device. nuc_density_term > 0 turns on
    nucleation with this span's draws nuc_rand [NJcap] and nuc_angles
    [MAX_NUC, 2]; melt_term turns on the moving melt pool at melt_left."""
    sample, y_r, y_c, overflow = forward_stage(regressor, classifier, state,
                                               ring)
    message_edges = (sample.push_mask.sum() + sample.pull_mask.sum()
                     + sample.connect_mask.sum())
    return post_forward_step(
        state, y_r, y_c, overflow, message_edges, r_threshold=r_threshold,
        c_threshold=c_threshold, span=span, ring=ring, max_elim=max_elim,
        max_switch=max_switch, nuc_density_term=nuc_density_term,
        nuc_rand=nuc_rand, nuc_angles=nuc_angles, melt_term=melt_term,
        melt_left=melt_left)


def post_forward_step(state: DeviceRolloutState, y_r, y_c, overflow,
                      message_edges, *, r_threshold: float = 1e-4,
                      c_threshold: float = 0.6, span: int = 6,
                      ring: int = tj.RING_MAX, max_elim: int = tj.MAX_ELIM,
                      max_switch: int = tj.MAX_SWITCH,
                      nuc_density_term: float = 0.0, nuc_rand=None,
                      nuc_angles=None, melt_term=None, melt_left=None):
    """The span after the forward: melt pool window, integrate, pick
    candidates, edit, nucleate, finalize."""
    pred_j, pred_g = y_r["joint"], y_r["grain"]
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
    nuc_overflow = torch.zeros((), dtype=torch.bool, device=xg.device)
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
    E_pp, n_pp, xg = finalize_stage(tstate.E_pp, tstate.E_pq, xg, tstate.xj,
                                    ring=ring)
    new_state = DeviceRolloutState(
        xg=xg, xj=tstate.xj, E_pp=E_pp, E_pq=tstate.E_pq,
        mask_g=tstate.mask_g, mask_j=tstate.mask_j, n_pp=n_pp,
        n_g=n_g, n_j=n_j, n_pq=n_pq)
    aux = {
        "grain_events": ge,
        "extra_events": extra,
        "switching": switching,
        "message_edges": message_edges,
        "ring_overflow": overflow,
        # the editor's appends past the capacity are dropped: fatal
        "pp_overflow": tstate.append_ptr > state.E_pp.shape[1],
        # candidates past the budget wait for the next span
        "elim_saturated": n_cand > max_elim,
        # a nucleation cursor within MAX_NUC sites of its array's end: fatal
        "nuc_overflow": nuc_overflow,
    }
    return new_state, aux


def check_capacity(aux: Dict[str, torch.Tensor]):
    """Raise if any span of a run dropped edges (ring or append capacity)
    or came within a nucleation site of the padded rows' end (never set
    without nucleation): its graph is corrupt. One device-to-host read per
    flag for the whole run."""
    for flag in ("ring_overflow", "pp_overflow", "nuc_overflow"):
        hits = aux[flag].reshape(-1).cpu().numpy()
        if hits.any():
            raise RuntimeError(
                f"rollout capacity bust: {flag} at span "
                f"{int(np.argmax(hits))}; raise `ring`/`pp_cap`/"
                "`nucleation_slack`")


def make_rollout(regressor, classifier, *, n_steps: int, **step_kw):
    """run(state, nuc_rand=None, nuc_angles=None, melt_lefts=None) ->
    (state, aux) over n_steps spans, aux stacked per span like a scan's
    output. With nucleation (step_kw nuc_density_term > 0) span i takes
    nuc_rand[i] ([n_steps, NJcap] draws) and nuc_angles[i] ([n_steps,
    MAX_NUC, 2]); with the moving melt pool (step_kw melt_term) it takes
    melt_lefts[i]. The loop runs without host sync; run() reads the
    capacity flags once after it and raises on a bust."""

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
        aux = {k: torch.stack([a[k] for a in auxs]) for k in auxs[0]}
        check_capacity(aux)
        return state, aux

    return run


def _to_device(a, dtype, device):
    return torch.as_tensor(np.asarray(a), dtype=dtype).to(device)


def init_device_state(x: Dict[str, np.ndarray], edges: Dict[str, np.ndarray],
                      mask: Dict[str, np.ndarray], *,
                      pp_cap: Optional[int] = None,
                      incremental: bool = False, nucleation_slack: int = 0,
                      device="cuda") -> DeviceRolloutState:
    """Pack host arrays (x/edges/mask dicts of the rollout engine) into a
    padded state on `device`. The E_pp capacity defaults to the live count
    plus one span's edit slack, rounded to 128 columns; E_pq gets a dead
    tail column so first-k queries that come up short read -1. The ELL
    tables are rebuilt from scratch every span (a stable sort, any size);
    persistent incremental columns are not ported.

    nucleation_slack > 0 makes room for that many nucleations: 6 E_pp and
    9 E_pq columns, one grain row and two joint rows each (dead pads), and
    seeds the cursors n_g, n_j and n_pq."""
    if incremental:
        raise NotImplementedError("incremental ELL columns")
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
        **cursors,
    )
