"""Editor state, the per-span event budgets of the device-side topology
editor, `update_jit` and the generate-mode nucleation pass. The editor
itself is kernels/editor_core.py (plain version) and
kernels/editor_fused.py (the CUDA kernel's wrapper); `update_jit` is the
JAX package's entry of the same edit, with its two-sided cleanup mask.

The nucleation pass is plain PyTorch with fixed shapes and no host sync: a
first-k query is a top-k over negated indices, a write that JAX drops when
it falls outside the array is a masked select over the whole row, and a
site that is absent runs the same body under a false `valid`.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

JOINT_SCALE = 5.0
RING_MAX = 16      # junction-ring capacity of one grain
MAX_SWITCH = 24    # neighbor-switching budget per span
MAX_ELIM = 8       # grain-elimination budget per span
MAX_TWOSIDED = 8   # two-sided-grain cleanup budget per pass
MAX_EXTRA = 2 * MAX_ELIM * (RING_MAX + 1)


@dataclasses.dataclass
class TopoState:
    E_pp: torch.Tensor       # [2, EP] int32 directed jj COO, -1 sentinels
    E_pq: torch.Tensor       # [2, EQ] int32 (joint, grain) COO
    xj: torch.Tensor         # [NJ, F] joint features (0:2 pos, 6:8 grads)
    y_joint: torch.Tensor    # [NJ, 2] predicted joint displacement
    mask_g: torch.Tensor     # [NG] int32
    mask_j: torch.Tensor     # [NJ] int32
    append_ptr: torch.Tensor  # [] int32: next free E_pp column
    # the moving melt pool's active-joint window [NJ] (None: all active)
    active_j: Optional[torch.Tensor] = None
    # next free E_pq column, for nucleation's 9 jg edges per site (None:
    # the state has no E_pq slack)
    q_ptr: Optional[torch.Tensor] = None

    def map(self, fn) -> "TopoState":
        """A copy with fn applied to every tensor field."""
        return map_fields(self, fn)


def map_fields(obj, fn):
    """A copy of the dataclass obj with fn applied to every field that is
    not None."""
    return dataclasses.replace(obj, **{
        f.name: fn(getattr(obj, f.name)) for f in dataclasses.fields(obj)
        if getattr(obj, f.name) is not None})


def update_jit(state: TopoState, edge_logits, grain_events, y_grain,
               threshold, num_grains: int, active_g=None,
               max_switch: int = MAX_SWITCH, cleanup_g_mask=None):
    """One span's topology update: edge_logits [EP] (dead columns at
    -1e30), grain_events [GE] (grain ids by ascending area, -1 pad),
    y_grain [NG, 2], active_g [NG] the melt pool's grain window (None: all)
    and cleanup_g_mask [NG] bool, which limits the two-sided cleanups to
    the grains it sets (None: every grain; the working-set editor passes
    its footprint). The editor kernel on the card, its plain version on
    the CPU (kernels/editor_fused.update_fused). Returns (state, switching
    [max_switch, 2], extra [2 * GE * (RING_MAX + 1) + 2 * max_switch])."""
    from ..kernels import editor_fused

    return editor_fused.update_fused(
        state, edge_logits, grain_events, y_grain, threshold, num_grains,
        max_switch=max_switch, active_g=active_g,
        cleanup_g_mask=cleanup_g_mask)


# ---------------------------------------------------------------------------
# nucleation (generate mode): one grain and two junctions per site
# ---------------------------------------------------------------------------

MAX_NUC = 4        # nucleation budget per span (the rate is ~1e-4 per joint)
NUC_AREA0 = 0.004
# side of the nucleus triangle, sqrt(area0 * 4/3 / sqrt(3)), in float32
_EDGE_LEN = float(np.sqrt(np.float32(NUC_AREA0 * 4.0 / 3.0)
                          / np.sqrt(np.float32(3.0))))
_NO = -(2 ** 30)


def _nonzero(cond, size: int, fill: int):
    """First `size` indices where cond holds, ascending, `fill` beyond: a
    top-k over negated indices (no host sync, unlike torch.nonzero)."""
    n = cond.shape[0]
    key = torch.where(cond, -torch.arange(n, dtype=torch.int32,
                                          device=cond.device), _NO)
    v = torch.topk(key, size).values
    return torch.where(v > _NO, -v, fill).to(torch.int32)


def _unit(p, pc, eps: float = 1e-6):
    """Unit vector from pc to the periodic image of p nearest it."""
    rel = p - pc
    rel = rel - (rel > 0.5).to(rel.dtype) + (rel < -0.5).to(rel.dtype)
    n = torch.sqrt(torch.sum(rel * rel))
    return rel / torch.clamp_min(n, eps)


def _at(vec, i):
    """vec[i] for a 0-d index tensor i, as a gather (no host sync)."""
    return torch.index_select(vec, 0, i.reshape(1).long())[0]


def _nucleate_one(state: TopoState, xg, n_g, n_j, junction, angles):
    """Insert one grain and two junctions at a live junction site: the old
    junction and the two new ones form a triangle around the nucleus, and
    the three old jg edges are redistributed so each new vertex borders the
    two old grains it faces. junction < 0, or a junction without exactly 3
    jj and 3 jg neighbours, changes nothing. Returns (state, xg, n_g, n_j,
    valid)."""
    E_pp, E_pq, xj = state.E_pp, state.E_pq, state.xj
    EP, EQ = E_pp.shape[1], E_pq.shape[1]
    NJ, NG = xj.shape[0], xg.shape[0]
    dev = xj.device
    valid = junction >= 0
    jct = torch.where(valid, junction, 0).to(torch.int32)

    # three joint neighbours and three grain neighbours, ascending column
    pp_hit = E_pp[0] == jct
    pq_hit = E_pq[0] == jct
    j_nbrs = E_pp[1][_nonzero(pp_hit, 3, EP - 1).long()]
    gns = E_pq[1][_nonzero(pq_hit, 3, EQ - 1).long()]
    valid = valid & (pp_hit.sum() == 3) & (pq_hit.sum() == 3)

    # ordered[k] = the grain neighbour NOT bordering j_nbrs[k]; the last
    # such candidate wins
    adj = ((E_pq[0][None, None, :] == j_nbrs[:, None, None])
           & (E_pq[1][None, None, :] == gns[None, :, None])).any(-1)
    ar3 = torch.arange(3, device=dev)
    sel = torch.where(~adj, ar3[None, :], -1).amax(dim=1)
    valid = valid & (sel >= 0).all()
    ordered = gns[sel.clamp_min(0)]
    gr0, gr1, gr2 = ordered[0], ordered[1], ordered[2]
    valid = valid & (gr0 != gr1) & (gr1 != gr2) & (gr0 != gr2)

    new_j1 = n_j
    new_j2 = n_j + 1
    site = _at(xj, jct)
    delta_z = site[-1]
    theta = angles * (math.pi / 2)

    # constants made on the device (a host tensor copied there would sync)
    def const(v):
        return torch.full((1,), v, dtype=xg.dtype, device=dev)

    grain_row = torch.cat([
        site[:3], const(NUC_AREA0), const(0.0),
        torch.stack([torch.cos(theta[0]), torch.sin(theta[0]),
                     torch.cos(theta[1]), torch.sin(theta[1])]).to(xg.dtype),
        const(NUC_AREA0), delta_z.reshape(1)])
    rows_g = torch.arange(NG, device=dev)
    xg = torch.where((valid & (rows_g == n_g))[:, None], grain_row, xg)

    # vertex triangle: the old junction moves toward j_nbrs[0], the new
    # ones toward j_nbrs[1] and j_nbrs[2]
    center = site[:2]
    nb_pos = xj[j_nbrs.clamp_min(0).long(), :2]
    pos = torch.stack([center + _unit(nb_pos[k], center) * _EDGE_LEN
                       for k in range(3)])
    v_new = site[None, :].repeat(2, 1)
    v_new[:, :2] = pos[1:]
    v_new[:, -2:] = 0.0
    rows_j = torch.arange(NJ, device=dev)
    is1 = (valid & (rows_j == new_j1))[:, None]
    is2 = (valid & (rows_j == new_j2))[:, None]
    xj = torch.where(is1, v_new[0], torch.where(is2, v_new[1], xj))
    moved = site.clone()
    moved[:2] = pos[0]
    moved[-2:] = 0.0
    xj = torch.where((valid & (rows_j == jct))[:, None], moved, xj)

    mask_j = torch.where(valid & ((rows_j == new_j1) | (rows_j == new_j2)),
                         1, state.mask_j).to(state.mask_j.dtype)
    mask_g = torch.where(valid & (rows_g == n_g), 1,
                         state.mask_g).to(state.mask_g.dtype)

    # kill the three old jg edges of the junction
    E_pq = torch.where(valid & pq_hit[None, :], -1, E_pq).to(torch.int32)

    # rewire the jj edges to and from j_nbrs[1] and j_nbrs[2]
    cols_p = torch.arange(EP, device=dev)

    def rewire(E, row, cond, val):
        col = _nonzero(cond, 1, EP - 1)[0]
        hit = valid & cond.any() & (cols_p == col)
        E = E.clone()
        E[row] = torch.where(hit, val, E[row]).to(E.dtype)
        return E

    E_pp = rewire(E_pp, 1, (E_pp[0] == j_nbrs[1]) & (E_pp[1] == jct), new_j1)
    E_pp = rewire(E_pp, 1, (E_pp[0] == j_nbrs[2]) & (E_pp[1] == jct), new_j2)
    E_pp = rewire(E_pp, 0, (E_pp[0] == jct) & (E_pp[1] == j_nbrs[1]), new_j1)
    E_pp = rewire(E_pp, 0, (E_pp[0] == jct) & (E_pp[1] == j_nbrs[2]), new_j2)

    # append the 6 triangle jj edges at append_ptr, the 9 jg edges at q_ptr
    i32 = lambda vs: torch.stack(vs).to(torch.int32)  # noqa: E731
    pp_new = i32([i32([jct, jct, new_j1, new_j1, new_j2, new_j2]),
                  i32([new_j1, new_j2, jct, new_j2, jct, new_j1])])
    E_pp = _put_cols(E_pp, pp_new, state.append_ptr, valid)
    pq_new = i32([i32([jct, new_j1, new_j2, new_j1, new_j2, jct, new_j2,
                       jct, new_j1]),
                  i32([n_g, n_g, n_g, gr0, gr0, gr1, gr1, gr2, gr2])])
    E_pq = _put_cols(E_pq, pq_new, state.q_ptr, valid)

    state = dataclasses.replace(
        state, E_pp=E_pp, E_pq=E_pq, xj=xj, mask_g=mask_g, mask_j=mask_j,
        append_ptr=torch.where(valid, state.append_ptr + 6,
                               state.append_ptr).to(torch.int32),
        q_ptr=torch.where(valid, state.q_ptr + 9,
                          state.q_ptr).to(torch.int32))
    n_g = torch.where(valid, n_g + 1, n_g).to(torch.int32)
    n_j = torch.where(valid, n_j + 2, n_j).to(torch.int32)
    return state, xg, n_g, n_j, valid


def _put_cols(E, vals, ptr, valid):
    """E[:, ptr + k] = vals[:, k] for k < vals.shape[1] where valid;
    columns past the end of E are dropped."""
    k = torch.arange(E.shape[1], device=E.device) - ptr
    inside = valid & (k >= 0) & (k < vals.shape[1])
    picked = vals[:, k.clamp(0, vals.shape[1] - 1)]
    return torch.where(inside[None, :], picked, E).to(E.dtype)


def nucleate_jit(state: TopoState, xg, n_g, n_j, rand_j, angles,
                 nucleation_prob):
    """Nucleation pass of one span: the first MAX_NUC live joints whose
    uniform draw rand_j [NJcap] is below nucleation_prob become sites, in
    ascending joint order, the k-th taking angles[k] [MAX_NUC, 2]. Needs
    state.q_ptr and, past the cursors, 9*MAX_NUC free E_pq columns,
    6*MAX_NUC E_pp columns, MAX_NUC grain rows and 2*MAX_NUC joint rows.
    Returns (state, xg, n_g, n_j, n_nucleated)."""
    sites = _nonzero((rand_j < nucleation_prob) & (state.mask_j > 0),
                     MAX_NUC, -1)
    oks = []
    for k in range(MAX_NUC):
        state, xg, n_g, n_j, ok = _nucleate_one(state, xg, n_g, n_j,
                                                sites[k], angles[k])
        oks.append(ok)
    return state, xg, n_g, n_j, torch.stack(oks).sum()
