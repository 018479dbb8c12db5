"""The stages of a static span after the forward, for one lane: feature
integration and z advance, the elimination candidates, the topology edit
(editor.py, on the CPU), the compaction of the jj list and the grain
centers. The elementwise stages run on the device of the lane's tensors,
in the order and form of float32 arithmetic that the span defines; `r`
rounds the float state after each of them (identity, or a control's
lower precision)."""

from __future__ import annotations

import torch

from . import editor
from .graph import wrap

TRAIN_FRAMES = 120
JOINT_SCALING, GRAIN_SCALING = 5.0, 20.0
AREA, EXTRAV, DAREA = 3, 4, 10       # grain feature columns
NEG = -1e30


def integrate(xg, xj, pred_j, pred_g, span: int):
    """Positions and areas advanced by the predictions, the predictions
    stored as the next span's gradient features, z advanced by one span
    (clamped at the last training frame, by row 0's z)."""
    xg, xj = xg.clone(), xj.clone()
    xj[..., :2] += pred_j / JOINT_SCALING
    xg[..., AREA] += pred_g[..., 0] / GRAIN_SCALING
    xg[..., EXTRAV] = pred_g[..., 1]
    xj[..., 6:8] = pred_j
    xg[..., DAREA] = pred_g[..., 0]
    dz = span / (TRAIN_FRAMES + 1)
    zmax = TRAIN_FRAMES / (TRAIN_FRAMES + 1)
    clamp = (xg[..., :1, 2] + dz) > zmax
    xg[..., 2] = torch.where(clamp, torch.full_like(xg[..., 2], zmax),
                             xg[..., 2] + dz)
    xj[..., 2] = torch.where(clamp, torch.full_like(xj[..., 2], zmax),
                             xj[..., 2] + dz)
    return xg, xj


def candidates(mask_g, area, r_threshold: float, max_elim: int):
    """Live grains whose predicted area is under r_threshold, by ascending
    area (ties by id), the first max_elim; -1 fills."""
    cond = (mask_g > 0) & (area < r_threshold)
    key = torch.where(cond, area, torch.full_like(area, float("inf")))
    order = torch.argsort(key, stable=True)
    return torch.where(torch.isfinite(key[order]), order.to(torch.int32),
                       -1)[:max_elim]


def compact(E_pp):
    """Live columns first, each part in its order; (E_pp, live count)."""
    live = E_pp[0] >= 0
    n = int(live.sum())
    return torch.cat([E_pp[:, live], E_pp[:, ~live]], dim=1), n


def centers(xg, xj, E_pq, ring: int):
    """Each grain's center: the mean of its junction ring, each junction
    taken at its periodic image nearest the previous center, mod 1 (kept
    where the ring has fewer than two junctions). The ring's slots are its
    live E_pq columns in ascending order, `ring` slots wide."""
    NG = xg.shape[0]
    dev = xg.device
    j, g = E_pq[0].long(), E_pq[1].long()
    live = (j >= 0) & (g >= 0)
    gk = torch.where(live, g, NG)
    order = torch.argsort(gk * E_pq.shape[1]
                          + torch.arange(E_pq.shape[1], device=dev))
    gs = gk[order]
    slot = torch.arange(gs.shape[0], device=dev) - torch.searchsorted(gs, gs)
    ok = (gs < NG) & (slot < ring)
    flat = torch.where(ok, gs * ring + slot, NG * ring)
    nbr = torch.zeros(NG * ring + 1, dtype=torch.int64, device=dev)
    nbr = nbr.index_put_((flat,), j[order])[:-1].reshape(NG, ring)
    rmask = torch.zeros(NG * ring + 1, dtype=torch.float32, device=dev)
    rmask = rmask.index_put_((flat,), ok.float())[:-1].reshape(NG, ring)
    prev = xg[:, :2]
    unwrapped = prev[:, None, :] + wrap(xj[:, :2][nbr] - prev[:, None, :])
    cnt = rmask.sum(dim=-1)
    cmean = torch.sum(unwrapped * rmask[..., None], dim=-2) / torch.clamp_min(
        cnt, 1.0)[..., None]
    xg = xg.clone()
    xg[:, :2] = torch.where((cnt >= 2)[..., None],
                            torch.remainder(cmean, 1.0), prev)
    return xg


def post_forward(lane, pred_j, pred_g, area, logits, *, span: int,
                 c_threshold: float, r_threshold: float, max_elim: int,
                 max_switch: int, ring: int, r):
    """One lane's span after its forward. lane: the span's starting state of
    the lane (xg, xj, E_pp, E_pq, mask_g, mask_j, n_pp); the predictions
    pred_j [NJ, 2], pred_g [NG, 2], area [NG] and the switch logits [EP].
    Returns the lane's next state and the span's events (grain_events,
    switching, extra_events), and whether the edit's appends overran the
    jj capacity."""
    xg, xj = integrate(lane["xg"], lane["xj"], pred_j, pred_g, span)
    xg, xj = r(xg), r(xj)
    ge = candidates(lane["mask_g"], area, r_threshold, max_elim)
    jj_live = lane["E_pp"][0] >= 0
    prob = torch.sigmoid(torch.where(jj_live, logits,
                                     torch.full_like(logits, NEG)).float())
    cpu = torch.device("cpu")
    out = editor.edit_lane(
        lane["E_pp"].to(cpu), lane["E_pq"].to(cpu), xj.to(cpu),
        pred_j.float().to(cpu), lane["mask_g"].to(cpu),
        lane["mask_j"].to(cpu), int(lane["n_pp"]), prob.to(cpu),
        ge.tolist(), pred_g[:, 0].float().to(cpu), c_threshold,
        xg.shape[0], max_switch)
    dev = xg.device
    E_pq = out["E_pq"].to(dev)
    E_pp, n_pp = compact(out["E_pp"].to(dev))
    xj = out["xj"].to(dev)
    xg = r(centers(xg, xj, E_pq, ring))
    return ({"xg": xg, "xj": xj, "E_pp": E_pp, "E_pq": E_pq,
             "mask_g": out["mask_g"].to(dev), "mask_j": out["mask_j"].to(dev),
             "n_pp": n_pp},
            {"grain_events": ge, "switching": out["switching"].to(dev),
             "extra_events": out["extra"].to(dev)},
            out["ptr"] > lane["E_pp"].shape[1])
