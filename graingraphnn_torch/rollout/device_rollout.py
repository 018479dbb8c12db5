"""Device-resident rollout span: one span runs entirely on the card, with no
host transfer inside the span loop.

    build ELL + edge lengths   (make_sample: sort-based, fixed shapes)
      -> regressor + classifier forward      (models.grain_nn)
      -> feature integration + z advance     (integrate_stage)
      -> elimination candidates              (elim_candidates)
      -> topology editor, one kernel launch  (kernels.editor_fused)
      -> E_pp compaction + grain centers     (finalize_stage)

Every array keeps a fixed shape with -1 sentinels for dead columns, so the
loop makes no data-dependent host decision; the capacity flags stay on the
device and are checked once after the loop (check_capacity).

Grain centers are the masked mean of each grain's junction ring unwrapped
into the periodic image of the previous center, taken mod 1; arithmetic is
float32. Scope: periodic boundary, static melt pool, no nucleation, ELL
tables rebuilt from scratch every span.
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
    """ELL rebuild + model forwards. Returns (sample, y_r, y_c,
    ring_overflow)."""
    sample, overflow = make_sample(state, ring)
    with torch.no_grad():
        y_r = regressor(sample)
        y_c = classifier(sample)
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


def elim_candidates(state, area, r_threshold, max_elim: int = tj.MAX_ELIM):
    """Live grains under the area threshold, ascending predicted area.
    Returns (ge [max_elim] int32, -1 pad; n_candidates)."""
    cond = (state.mask_g > 0) & (area < r_threshold)
    key = torch.where(cond, area, torch.full_like(area, float("inf")))
    order = torch.argsort(key, stable=True)
    n_cand = torch.isfinite(key).sum()
    ge = torch.where(torch.isfinite(key[order]), order.to(torch.int32), -1)
    return ge[:max_elim], n_cand


def edit_stage(state, xg, xj, pred_j, pred_g, edge_logits, ge, c_threshold,
               max_switch: int = tj.MAX_SWITCH):
    """The span's topology edit in one editor launch. Returns (tstate,
    switching, extra)."""
    jj_live = state.E_pp[0] >= 0
    logits = torch.where(jj_live, edge_logits, torch.full_like(edge_logits, NEG))
    tstate = tj.TopoState(
        E_pp=state.E_pp, E_pq=state.E_pq, xj=xj, y_joint=pred_j,
        mask_g=state.mask_g, mask_j=state.mask_j, append_ptr=state.n_pp,
    )
    return editor_fused.update_fused(
        tstate, logits, ge, pred_g, c_threshold, xg.shape[0],
        max_switch=max_switch)


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


def _refuse_deferred(nuc_density_term, melt_term):
    if nuc_density_term:
        raise NotImplementedError("generate-mode nucleation in the span")
    if melt_term is not None:
        raise NotImplementedError("moving melt pool (melt_stage)")


def device_step(regressor, classifier, state: DeviceRolloutState, *,
                r_threshold: float = 1e-4, c_threshold: float = 0.6,
                span: int = 6, ring: int = tj.RING_MAX,
                max_elim: int = tj.MAX_ELIM, max_switch: int = tj.MAX_SWITCH,
                nuc_density_term: float = 0.0, melt_term=None):
    """One rollout span. Returns (next_state, aux): aux holds the span's
    grain events, extra events, switching pairs, message-edge count and
    capacity flags, all on the device."""
    _refuse_deferred(nuc_density_term, melt_term)
    sample, y_r, y_c, overflow = forward_stage(regressor, classifier, state,
                                               ring)
    message_edges = (sample.push_mask.sum() + sample.pull_mask.sum()
                     + sample.connect_mask.sum())
    return post_forward_step(
        state, y_r, y_c, overflow, message_edges, r_threshold=r_threshold,
        c_threshold=c_threshold, span=span, ring=ring, max_elim=max_elim,
        max_switch=max_switch)


def post_forward_step(state: DeviceRolloutState, y_r, y_c, overflow,
                      message_edges, *, r_threshold: float = 1e-4,
                      c_threshold: float = 0.6, span: int = 6,
                      ring: int = tj.RING_MAX, max_elim: int = tj.MAX_ELIM,
                      max_switch: int = tj.MAX_SWITCH,
                      nuc_density_term: float = 0.0, melt_term=None):
    """The span after the forward: integrate, pick candidates, edit,
    finalize."""
    _refuse_deferred(nuc_density_term, melt_term)
    pred_j, pred_g = y_r["joint"], y_r["grain"]
    xg, xj = integrate_stage(state, pred_j, pred_g, span)
    ge, n_cand = elim_candidates(state, y_r["grain_area"], r_threshold,
                                 max_elim)
    tstate, switching, extra = edit_stage(
        state, xg, xj, pred_j, pred_g, y_c["edge_event"], ge, c_threshold,
        max_switch)
    E_pp, n_pp, xg = finalize_stage(tstate.E_pp, tstate.E_pq, xg, tstate.xj,
                                    ring=ring)
    new_state = DeviceRolloutState(
        xg=xg, xj=tstate.xj, E_pp=E_pp, E_pq=tstate.E_pq,
        mask_g=tstate.mask_g, mask_j=tstate.mask_j, n_pp=n_pp)
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
    }
    return new_state, aux


def check_capacity(aux: Dict[str, torch.Tensor]):
    """Raise if any span of a run dropped edges (ring or append capacity):
    its graph is corrupt. One device-to-host read for the whole run."""
    for flag in ("ring_overflow", "pp_overflow"):
        hits = aux[flag].reshape(-1).cpu().numpy()
        if hits.any():
            raise RuntimeError(
                f"rollout capacity bust: {flag} at span "
                f"{int(np.argmax(hits))}; raise `ring`/`pp_cap`")


def make_rollout(regressor, classifier, *, n_steps: int, **step_kw):
    """run(state) -> (state, aux) over n_steps spans, aux stacked per span
    like a scan's output. The loop runs without host sync; run() reads the
    capacity flags once after it and raises on a bust."""
    def run(state: DeviceRolloutState):
        auxs = []
        for _ in range(n_steps):
            state, aux = device_step(regressor, classifier, state, **step_kw)
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
    persistent incremental columns and nucleation slack are not ported."""
    if incremental:
        raise NotImplementedError("incremental ELL columns")
    if nucleation_slack:
        raise NotImplementedError("nucleation slack")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("init_device_state: no CUDA device; pass "
                           "device='cpu' to run the plain versions")
    connect = np.asarray(edges["connect"], np.int64)
    connect = connect[:, connect[0] >= 0]
    slack = 2 * (tj.MAX_ELIM * 3 + tj.MAX_TWOSIDED + 2)
    EP = pp_cap or round_up(connect.shape[1] + slack, 128)
    E_pp = np.full((2, EP), -1, np.int32)
    E_pp[:, : connect.shape[1]] = connect
    pull_in = np.asarray(edges["pull"], np.int64)
    EQ = round_up(pull_in.shape[1] + 1, 128)
    pull = np.full((2, EQ), -1, np.int32)
    pull[:, : pull_in.shape[1]] = pull_in
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
    )
