"""The partitioned rollout: D ranks roll one graph out together, span by
span, each rank holding a stripe of the nodes for the forward and a block
of the edge columns for the edit.

  per span, on every rank:
    <1> the halo-striped span forward (parallel.halo): nodes split into D
        periodic x-stripes, both models' forwards on the rank's stripe
        with a neighbour exchange per source table (node_proj and
        edge_attn over [left | local | right] source rows on the card);
        stripe capacities are pinned at span 0 with headroom;
    <2> feature integration and the z advance, <3a> elimination
        candidates (device_rollout.integrate_stage / elim_candidates) on
        the node arrays, whole on every rank;
    <3b> the column-sharded edit (parallel.sharded_editor): detection,
        closure and scatter-back on the rank's column block, the mini edit
        (the editor kernel) on every rank alike. An `invalid` working set
        runs the span's edit again with wq / wp doubled and one more
        closure round; the grown working set stays for later spans;
    <5> the shared finalize (device_rollout.finalize_stage, the code the
        one-device span runs) on the edited columns gathered from every
        rank: column-table maintenance, E_pp compaction, grain centers.

Every rank builds the same stripes from the same arrays (SPMD), so the
state after each span is the same on every rank, and equal to the
one-device span's: topology bit-equal, positions to float rounding where
the striped forward sums in another order.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..graph import schema
from ..graph.state import round_up
from ..rollout import device_rollout as dr
from ..rollout import topology_jit as tj
from . import halo
from . import sharded_editor as se
from .mesh import Mesh


def _np_lengths(pos_src, pos_dst, src, dst):
    """Periodic edge lengths on the host, float32, as the device computes
    them (device_rollout._coo_lengths)."""
    s = np.where(src >= 0, src, 0)
    d = np.where(dst >= 0, dst, 0)
    rel = (pos_src[s] - pos_dst[d]).astype(np.float32)
    rel = (rel - (rel > 0.5).astype(np.float32)
           + (rel < -0.5).astype(np.float32))
    return np.sqrt(np.sum(rel * rel, axis=-1, dtype=np.float32))


def stripe_offsets(grain_x, offset_j, factor):
    """PartitionedRollout's stripe_offsets for a patch of the domain
    tiled `factor` times in x: the grains' patch offsets from their
    unscaled features `grain_x` [NG, >=1] and the joints' from
    `offset_j` [NJ, 2] (device_driver.init_scaled_state's). None when the
    patch is the whole domain (factor <= 1)."""
    if factor <= 1:
        return None
    return (np.floor(np.asarray(grain_x, float)[:, 0] * factor),
            offset_j[:, 0], factor)


class PartitionedRollout:
    """Multi-span partitioned rollout on the ranks of a Mesh.

    Parameters follow device_rollout.make_rollout; `wq` / `wp` are the
    sharded editor's first working-set capacities (doubled on a bust, at
    most `max_retries` times a span). Scope: the periodic boundary, the
    static melt pool, no nucleation.

    `stripe_offsets = (offset_gx [NG], offset_jx [NJ], domain_factor)`
    stripes the forward by PHYSICAL x, ((scaled + offset) / factor),
    instead of the patch-scaled feature x: the scaled torus keeps the
    40 um interaction range (~0.14) whatever the domain, capping D at ~4,
    and physical striping shortens the edges by the factor. The offsets
    are kept current per span by detecting wrap crossings of the scaled
    torus (|dx| > 0.5 between spans; a span moves a node ~0.04). They,
    and the grown working set, change with the trajectory: use one
    instance per rollout.
    """

    def __init__(self, regressor, classifier, mesh: Mesh, *, span: int = 6,
                 r_threshold: float = 1e-4, c_threshold: float = 0.6,
                 ring: int = tj.RING_MAX, max_elim: int = tj.MAX_ELIM,
                 max_switch: int = tj.MAX_SWITCH, wq: int = 1024,
                 wp: int = 1024, rounds: int = 3, max_retries: int = 8,
                 cap_headroom: float = 1.5, stripe_offsets=None):
        self.mesh, self.D = mesh, mesh.D
        self.span = span
        self.r_threshold = r_threshold
        self.c_threshold = c_threshold
        self.ring = ring
        self.max_elim = max_elim
        self.max_switch = max_switch
        self.rounds = rounds
        self.max_retries = max_retries
        self.cap_headroom = cap_headroom
        self.stripe_offsets = None
        if stripe_offsets is not None:
            off_g, off_j, factor = stripe_offsets
            self.stripe_offsets = (
                np.asarray(off_g, np.float64).reshape(-1),
                np.asarray(off_j, np.float64).reshape(-1), float(factor))
        self._prev_stripe_x = None
        # the mini edit's budgets (max_switch candidates, the dead last
        # column) need a least width: the JAX package's floor
        floor = max(128, 2 * max_switch)
        self._wq, self._wp = max(wq, floor), max(wp, floor)
        self._caps: Optional[Dict[str, int]] = None
        self._span_fwd = halo.make_halo_span_forward(regressor, classifier,
                                                     mesh)

    def _editor(self, wq: int, wp: int, rounds: int):
        return se.make_sharded_editor(self.mesh, wq=wq, wp=wp, rounds=rounds,
                                      max_switch=self.max_switch)

    def _stripe_x(self, xg, xj):
        """Physical stripe coordinates where patch offsets are given, the
        offsets kept current across wrap crossings (class docstring)."""
        if self.stripe_offsets is None:
            return None
        off_g, off_j, factor = self.stripe_offsets
        if self._prev_stripe_x is not None:
            pgx, pjx = self._prev_stripe_x
            dg = xg[:, 0] - pgx
            off_g = off_g - (dg > 0.5) + (dg < -0.5)
            dj = xj[:, 0] - pjx
            off_j = off_j - (dj > 0.5) + (dj < -0.5)
            self.stripe_offsets = (off_g, off_j, factor)
        self._prev_stripe_x = (xg[:, 0].copy(), xj[:, 0].copy())
        return {"grain": ((xg[:, 0] + off_g) / factor) % 1.0,
                "joint": ((xj[:, 0] + off_j) / factor) % 1.0}

    def _stripe_caps(self, feats, ei, ew, mask, stripe_x):
        """Stripe capacities pinned with headroom; pinned again only when
        a later span outgrows them."""
        _s, meta = halo.build_striped(feats, ei, ew, mask, self.D,
                                      stripe_x=stripe_x)
        h = self.cap_headroom
        return {"grain_cap": round_up(int(meta.grain_cap * h) + 8, 8),
                "joint_cap": round_up(int(meta.joint_cap * h) + 8, 8),
                "jj_cap": round_up(int(meta.jj_cap * h) + 8, 8)}

    def host_graph(self, st: dr.DeviceRolloutState):
        """The state as build_striped's host graph: (features, edge
        indices, edge lengths, masks), numpy."""
        xg, xj = st.xg.cpu().numpy(), st.xj.cpu().numpy()
        E_pp, E_pq = st.E_pp.cpu().numpy(), st.E_pq.cpu().numpy()
        pq_len = _np_lengths(xj[:, :2], xg[:, :2], E_pq[0], E_pq[1])
        pp_len = _np_lengths(xj[:, :2], xj[:, :2], E_pp[0], E_pp[1])
        push_t, pull_t, conn_t = schema.EDGE_TYPES
        feats = {"grain": xg, "joint": xj}
        ei = {push_t: np.stack([E_pq[1], E_pq[0]]), pull_t: E_pq,
              conn_t: E_pp}
        ew = {push_t: pq_len[:, None], pull_t: pq_len[:, None],
              conn_t: pp_len[:, None]}
        mask = {"grain": st.mask_g.cpu().numpy().astype(np.float32),
                "joint": st.mask_j.cpu().numpy().astype(np.float32)}
        return feats, ei, ew, mask

    def _forward(self, st: dr.DeviceRolloutState):
        """<1>: the striped span forward from the current positions."""
        feats, ei, ew, mask = self.host_graph(st)
        E_pp = ei[schema.EDGE_TYPES[2]]
        if ((E_pp[0] >= 0) != (E_pp[1] >= 0)).any():
            raise AssertionError("half-dead E_pp column (invariant bust)")
        stripe_x = self._stripe_x(feats["grain"], feats["joint"])
        if self._caps is None:
            self._caps = self._stripe_caps(feats, ei, ew, mask, stripe_x)
        try:
            pred = self._span_fwd(feats, ei, ew, mask, self.D,
                                  caps=self._caps, stripe_x=stripe_x)
        except ValueError as e:
            if "stripe capacity" not in str(e):
                raise
            self._caps = self._stripe_caps(feats, ei, ew, mask, stripe_x)
            pred = self._span_fwd(feats, ei, ew, mask, self.D,
                                  caps=self._caps, stripe_x=stripe_x)
        live = np.nonzero((E_pp[0] >= 0) & (E_pp[1] >= 0))[0]
        logits = torch.full((E_pp.shape[1],), se.NEG, dtype=torch.float32,
                            device=st.xg.device)
        logits[torch.from_numpy(live).to(logits.device)] = pred["edge_event"]
        return pred, logits

    def step(self, st: dr.DeviceRolloutState):
        """One span. Returns (next_state, aux)."""
        EP, EQ = st.E_pp.shape[1], st.E_pq.shape[1]
        if EP % self.D or EQ % self.D:
            raise ValueError(
                f"edge capacities ({EP}, {EQ}) must divide the number of "
                f"ranks {self.D} (init_device_state rounds to 128 columns)")
        pred, logits = self._forward(st)

        # <2>/<3a> integration and elimination candidates
        pred_j, pred_g = pred["joint"], pred["grain"]
        xg2, xj2 = dr.integrate_stage(st, pred_j, pred_g, self.span)
        ge, n_cand = dr.elim_candidates(st, pred["grain_area"],
                                        self.r_threshold, self.max_elim)

        # <3b> the column-sharded edit, sized up and run again on a bust
        r, bp, bq = self.mesh.rank, EP // self.D, EQ // self.D
        blk_pp = st.E_pp[:, r * bp: (r + 1) * bp].contiguous()
        blk_pq = st.E_pq[:, r * bq: (r + 1) * bq].contiguous()
        blk_lg = logits[r * bp: (r + 1) * bp].contiguous()
        wq, wp, rounds = self._wq, self._wp, self.rounds
        retries = 0
        while True:
            (pp_l, pq_l, xj3, mg2, mj2, _n_pp, sw, ex,
             invalid) = self._editor(wq, wp, rounds)(
                blk_pp, blk_pq, blk_lg, xj2, pred_j, st.mask_g, st.mask_j,
                st.n_pp, ge, pred_g, self.c_threshold)
            if not bool(invalid):
                break
            # each retry doubles the working set (a footprint past its
            # capacity) and adds a closure round (a cascade deeper than
            # the closure); past the whole padded edge array what is left
            # is an append-capacity bust
            if retries >= self.max_retries or wp > 2 * EP:
                raise RuntimeError(
                    f"sharded editor still invalid at working set {wq}/{wp}"
                    f", {rounds} closure rounds (E_pp capacity {EP}): raise "
                    "pp_cap (append headroom) on the rollout state")
            wq, wp, rounds = 2 * wq, 2 * wp, rounds + 1
            retries += 1
        self._wq, self._wp, self.rounds = wq, wp, rounds

        # <5> the shared finalize on the gathered columns
        E_pp2 = self.mesh.all_gather(pp_l).permute(1, 0, 2).reshape(2, EP)
        E_pq2 = self.mesh.all_gather(pq_l).permute(1, 0, 2).reshape(2, EQ)
        (E_pp3, n_pp3, pull_cols, push_cols, connect_cols, xg3,
         ov_fin) = dr.finalize_stage(
            st.E_pp, st.E_pq, E_pp2, E_pq2, st.pull_cols, st.push_cols,
            st.connect_cols, xg2, xj3, ring=self.ring)
        if bool(ov_fin):
            raise RuntimeError("column-table overflow (ring bust) in the "
                               "partitioned finalize: raise ring")
        st2 = dr.DeviceRolloutState(
            xg=xg3, xj=xj3, E_pp=E_pp3, E_pq=E_pq2, mask_g=mg2, mask_j=mj2,
            n_pp=n_pp3, pull_cols=pull_cols, push_cols=push_cols,
            connect_cols=connect_cols)
        aux = {
            "grain_events": ge.cpu().numpy(),
            "extra_events": ex.cpu().numpy(),
            "switching": sw.cpu().numpy(),
            "elim_saturated": bool(n_cand > self.max_elim),
            "editor_retries": retries,
            # capacity failures raise above; the device driver's aux keys
            "ring_overflow": False,
            "pp_overflow": False,
        }
        return st2, aux

    def run(self, st: dr.DeviceRolloutState, n_steps: int):
        """Advance n_steps spans. Returns (state, aux), the aux values
        stacked on a leading span axis."""
        auxs = []
        for _ in range(n_steps):
            st, aux = self.step(st)
            auxs.append(aux)
        return st, {k: np.stack([a[k] for a in auxs]) for k in auxs[0]}
