"""Column-sharded topology editor: each rank holds a contiguous block of the
E_pp and E_pq columns, and one span's update runs as

  1. detection, on the rank's block: switch candidates from its logits,
     ring counts by a local scatter-add and a sum over the ranks, seed
     masks by a local scatter-or and a max over the ranks;
  2. footprint closure, on the block: editor_workset's hop expansion with
     a max over the ranks after every scatter-or step, so the [NJ] / [NG]
     masks every rank holds are the one-device masks;
  3. working-set gather: each rank compacts its selected columns; an
     all_gather and a merge in rank order give the global ascending column
     order editor_workset relies on;
  4. the mini edit, on every rank alike: update_jit (the editor kernel on
     the card) on the gathered mini state, its cleanup limited to the
     footprint's grains;
  5. scatter-back, local: each rank rewrites its own columns from the mini
     result; the appended reconnection columns land on the ranks that own
     the global append cursor's range.

Steps 1-3 compute what editor_workset computes on one device. No rank
holds the full arrays, so there is no full-array fallback here: a working
set past its capacity, a live last column or a guard-shell hit comes back
as `invalid`, and the caller sizes the working set up and runs the span
again (parallel.partitioned_rollout). Node arrays (positions, masks) stay
whole on every rank: the mini edit writes them directly.
"""

from __future__ import annotations

import numpy as np
import torch

from ..rollout import editor_workset as ew
from ..rollout import topology_jit as tj
from .mesh import Mesh

NEG = -1e30


def _pmax_bool(mesh: Mesh, m):
    return mesh.all_reduce(m, "max")


def _closure_sharded(mesh: Mesh, pp_l, pq_l, seed_j, seed_g, rounds):
    """editor_workset._closure with a max over the ranks after each
    scatter-or step (the same steps in the same order, so the masks are
    the one-device masks)."""
    return ew._closure(pp_l, pq_l, seed_j, seed_g, rounds,
                       reduce=lambda m: _pmax_bool(mesh, m))


def _gather_selected(mesh: Mesh, sel_l, vals_l, block, cap, fill):
    """Compact the rank's selected columns, all_gather and merge in rank
    order (the global ascending column order). vals_l [v, block] rows
    ride along. Returns (global_cols [cap], vals [v, cap], count,
    overflow)."""
    cols_l, n_l, _ = ew._compact_cols(sel_l, cap)
    safe = torch.where(cols_l >= 0, cols_l, 0).long()
    vals_sel = torch.where(cols_l[None, :] >= 0, vals_l[:, safe],
                           torch.full_like(vals_l[:, :1], fill))
    gcols_l = torch.where(cols_l >= 0, cols_l + mesh.rank * block, -1)
    all_cols = mesh.all_gather(gcols_l)                  # [D, cap]
    all_vals = mesh.all_gather(vals_sel)                 # [D, v, cap]
    all_n = mesh.all_gather(n_l.reshape(1))[:, 0]        # [D]
    total = all_n.sum()
    # rank-major flatten of each rank's live prefix -> the first `total`
    # slots of a [cap] buffer
    off = torch.cumsum(all_n, 0) - all_n
    lane = torch.arange(cap, device=sel_l.device)
    pos = off[:, None] + lane[None, :]
    okm = (lane[None, :] < all_n[:, None]) & (pos < cap)
    tgt = torch.where(okm, pos, cap).reshape(-1).long()
    out_cols = torch.full((cap + 1,), -1, dtype=torch.int32,
                          device=sel_l.device)
    out_cols[tgt] = all_cols.reshape(-1)
    v = all_vals.shape[1]
    out_vals = torch.full((v, cap + 1), fill, dtype=all_vals.dtype,
                          device=sel_l.device)
    out_vals[:, tgt] = all_vals.transpose(0, 1).reshape(v, -1)
    return out_cols[:cap], out_vals[:, :cap], total, total > cap


def make_sharded_editor(mesh: Mesh, *, wq: int = 1024, wp: int = 1024,
                        rounds: int = 3, max_switch: int = tj.MAX_SWITCH):
    """f(E_pp, E_pq, logits, xj, y_joint, mask_g, mask_j, n_pp,
    grain_events, y_grain, threshold) -> (E_pp, E_pq, xj, mask_g, mask_j,
    n_pp, switching, extra, invalid), with E_pp / E_pq / logits this rank's
    column blocks ([2, EP / D], [2, EQ / D], [EP / D]) and everything else
    whole on every rank. Column counts must divide by D, and the global
    last column must be dead (pad with dead columns: pad_cols_to)."""
    D = mesh.D

    def f(E_pp, E_pq, logits, xj, y_joint, mask_g, mask_j, n_pp,
          grain_events, y_grain, threshold):
        NG, NJ = mask_g.shape[0], mask_j.shape[0]
        bp, bq = E_pp.shape[1], E_pq.shape[1]
        EP = bp * D
        n_pp = torch.as_tensor(n_pp, dtype=torch.int32, device=E_pp.device)

        # ---- 1. detection ----------------------------------------------
        prob = torch.sigmoid(logits.float())
        seed_j, seed_g, counts, _n = ew.seeds(E_pp, E_pq, prob,
                                              grain_events, threshold, NJ,
                                              NG)
        seed_j = _pmax_bool(mesh, seed_j)
        counts = mesh.all_reduce(counts, "sum")
        seed_g = seed_g | ((counts > 0) & (counts <= 2))

        # ---- 2. closure -------------------------------------------------
        fp_j, fp_g, shell_j, shell_g = _closure_sharded(
            mesh, E_pp, E_pq, seed_j, seed_g, rounds)

        # ---- 3. working-set gather --------------------------------------
        sel_q, sel_p = ew.selection(E_pp, E_pq, fp_j, fp_g)
        q_cols, q_vals, _n_q, of_q = _gather_selected(
            mesh, sel_q, E_pq, bq, wq - 1, -1)
        # joint ids and logits in separate gathers: ids stay int32
        p_cols, mini_p, n_p, of_p = _gather_selected(
            mesh, sel_p, E_pp, bp, wp, -1)
        _, p_lg, _, _ = _gather_selected(mesh, sel_p, logits[None, :].float(),
                                         bp, wp, NEG)
        of_p = of_p | (n_p > wp - ew.SLACK)
        # the global last column lies in the last rank's block
        tail = (E_pq[0, bq - 1] < 0) & (E_pp[0, bp - 1] < 0)
        tail_dead = mesh.all_reduce(tail & (mesh.rank == D - 1), "max")
        invalid = of_q | of_p | ~tail_dead
        mini_q = torch.full((2, wq), -1, dtype=torch.int32,
                            device=E_pq.device)
        mini_q[:, : wq - 1] = q_vals.to(torch.int32)

        # ---- 4. the mini edit, on every rank ----------------------------
        mini_state = tj.TopoState(
            E_pp=mini_p.to(torch.int32), E_pq=mini_q, xj=xj,
            y_joint=y_joint, mask_g=mask_g, mask_j=mask_j,
            append_ptr=n_p.to(torch.int32))
        mst, switching, extra = tj.update_jit(
            mini_state, p_lg[0], grain_events, y_grain, threshold, NG,
            max_switch=max_switch, cleanup_g_mask=fp_g)
        invalid = invalid | ew.shell_touched(mask_j, mask_g, mst, shell_j,
                                             shell_g, wp)

        # ---- 5. local scatter-back --------------------------------------
        def localize(gcols, width):
            lo = mesh.rank * width
            mine = (gcols >= lo) & (gcols < lo + width)
            return torch.where(mine, gcols - lo, width)

        E_pq = ew._put(E_pq, localize(q_cols, bq), mst.E_pq[:, : wq - 1])
        E_pp = ew._put(E_pp, localize(p_cols, bp), mst.E_pp[:, :wp])
        # appended columns -> the rank(s) owning [n_pp, n_pp + n_app)
        vals, n_app, lanes = ew.appended(mst, n_p.to(torch.int32), wp)
        gtgt = torch.where(lanes < n_app, n_pp + lanes, EP)
        E_pp = ew._put(E_pp, localize(gtgt, bp), vals)
        app_over = n_pp + n_app > EP
        n_pp_out = torch.where(app_over, EP + 1, n_pp + n_app).to(
            torch.int32)
        return (E_pp, E_pq, mst.xj, mst.mask_g, mst.mask_j, n_pp_out,
                switching, extra, invalid | app_over)

    return f


def pad_cols_to(arr, width, fill=-1):
    """Host helper: a [2, E] COO (or [E] vector) padded with dead columns
    to `width` (the global last column stays dead)."""
    arr = np.asarray(arr)
    if arr.ndim == 1:
        out = np.full(width, fill, arr.dtype)
        out[: arr.shape[0]] = arr
        return out
    out = np.full((arr.shape[0], width), fill, arr.dtype)
    out[:, : arr.shape[1]] = arr
    return out
