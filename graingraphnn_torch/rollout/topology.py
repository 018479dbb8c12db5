"""The host topology editor of the rollout engine, numpy in float64.

One span's edit (reference models.py:614-1053), in this order:

1. the edge-event logits, through a numpy sigmoid, over the threshold on
   u < v junction edges become switch candidates;
2. each predicted grain elimination collapses the |ring| - 2 ring edges of
   the smallest darea by neighbor switching, then deletes the grain and
   its last two junctions and reconnects (grains the collapse leaves with
   two sides go too, forced eliminations are reported);
3. the remaining switches run in descending probability;
4. with nucleation_prob > 0, one grain and two junctions are inserted at
   each random junction site (draws from the editor's rng);
5. deleted (-1) edge columns are compacted and push is rebuilt as the
   flipped pull.

The order of events depends on the data, so this runs on the host
between the card's forwards; the device editor (kernels.editor_fused)
is the engine's --jit_editor counterpart. x and mask change in place,
and masks mark eliminated nodes: rows are never removed.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np

from ..graph.geometry import point_in_triangle

JOINT_SCALE = 5.0
GRAIN_SCALE = 20.0


def _periodic_move_np(p, pc):
    rel = p - pc
    return p - 1.0 * (rel > 0.5) + 1.0 * (rel < -0.5)


def _unit_np(p, pc, eps=1e-6):
    rel = p - pc
    rel = rel - 1.0 * (rel > 0.5) + 1.0 * (rel < -0.5)
    n = np.sqrt(np.sum(rel * rel))
    return rel / max(n, eps)


class TopologyEditor:
    """Mutable rollout graph state: node features, masks, COO edges."""

    def __init__(self, threshold: float = 0.6, rng: np.random.Generator | None = None,
                 verbose: bool = False):
        self.threshold = threshold
        self.rng = rng or np.random.default_rng(0)
        self.verbose = verbose

    def _log(self, *a):
        if self.verbose:
            print(*a)

    def update(
        self,
        x: Dict[str, np.ndarray],          # {'grain': [NG,11], 'joint': [NJ,8]}
        edges: Dict[str, np.ndarray],      # {'connect': [2,Ejj], 'pull': [2,Ejg], 'push': [2,Ejg]}
        y: Dict[str, np.ndarray],          # predictions incl. 'edge_event' logits,
                                           # 'joint' [NJ,2], 'grain' [NG,2], 'grain_event' idx array
        mask: Dict[str, np.ndarray],       # {'grain': [NG,1], 'joint': [NJ,1]}
        active_grains: np.ndarray | None = None,
        active_joints: np.ndarray | None = None,
        nucleation_prob: float = 0.0,
    ):
        """Returns (x, edges, switching_list, extra_events). Mutates x/mask
        in place; `edges` arrays are replaced (compacted)."""
        E_pp = np.array(edges["connect"], dtype=np.int64)
        E_pq = np.array(edges["pull"], dtype=np.int64)

        if active_grains is None:
            active_grains = np.ones(len(x["grain"]), dtype=bool)
        if active_joints is None:
            active_joints = np.ones(len(x["joint"]), dtype=bool)

        src, dst = E_pp[0], E_pp[1]
        prob = 1.0 / (1.0 + np.exp(-np.asarray(y["edge_event"], dtype=np.float64)))
        L1 = list(np.nonzero((prob > self.threshold) & (src < dst))[0])

        unexpected_elim: List[int] = []

        # ---------------- grain elimination ------------------------------
        for grain in list(np.asarray(y["grain_event"]).reshape(-1)):
            grain = int(grain)
            if not active_grains[grain]:
                continue
            Np = E_pq[0][E_pq[1] == grain]
            if len(Np) == 0:
                continue
            if not all(active_joints[int(p)] for p in Np):
                continue

            L2: List[int] = []
            Nq: List[int] = []
            ok = True
            for ii in range(len(Np)):
                for jj in range(ii + 1, len(Np)):
                    p1, p2 = int(Np[ii]), int(Np[jj])
                    if p1 > p2:
                        p1, p2 = p2, p1
                    e_idx = np.nonzero((E_pp[0] == p1) & (E_pp[1] == p2))[0]
                    if len(e_idx) == 0:
                        continue
                    L2.extend(e_idx.tolist())
                    nq1 = E_pq[1][(E_pq[0] == p1) & (E_pq[1] != grain)]
                    nq2 = E_pq[1][(E_pq[0] == p2) & (E_pq[1] != grain)]
                    if nq1[0] in nq2:
                        Nq.append(int(nq1[0]))
                    elif len(nq1) > 1 and nq1[1] in nq2:
                        Nq.append(int(nq1[1]))
                    else:
                        ok = False
            if not ok or len(Nq) != len(Np):
                self._log("skip elimination of grain", grain, "(ring mismatch)")
                continue
            if len(np.unique(Nq)) != len(Nq):
                continue

            order = np.argsort(np.asarray(y["grain"])[Nq, 0])
            L2 = [L2[i] for i in order[:-2]]

            force_elim = self._switch_edges(
                E_pp, E_pq, x, y, L2, elim_grain=grain, active_joints=active_joints
            )
            unexpected_elim.extend(force_elim)
            force_elim = [grain] + force_elim
            if len(force_elim) > 1:
                self._log("force eliminated grains", force_elim[1:])
            for fg in force_elim:
                E_pp, E_pq = self._delete_grain(int(fg), E_pp, E_pq, mask)
            for e in L2:
                if e in L1:
                    L1.remove(e)

            # per-grain cleanup: two-sided grains removed but NOT recorded as
            # events (matches models.py:712-722)
            E_pp, E_pq, _ = self._drop_two_sided(E_pp, E_pq, mask)

        # ---------------- neighbor switching -----------------------------
        L1 = sorted(L1, key=lambda e: -prob[e])
        L1 = [e for e in L1 if E_pp[0, e] != -1]
        self._switch_edges(E_pp, E_pq, x, y, L1, elim_grain=None, active_joints=active_joints)
        switching_list = E_pp.T[L1].copy()

        E_pp, E_pq, dropped = self._drop_two_sided(E_pp, E_pq, mask)
        unexpected_elim.extend(dropped)

        extra_events = np.array(unexpected_elim, dtype=np.int64)

        # ---------------- nucleation -------------------------------------
        if nucleation_prob > 1e-6:
            x, mask, E_pp, E_pq = self._nucleate(
                x, mask, E_pp, E_pq, nucleation_prob
            )

        # compact deleted slots, regenerate reverse type (models.py:840-864)
        E_pq = E_pq[:, E_pq[0] != -1]
        E_pp = E_pp[:, E_pp[0] != -1]
        new_edges = {
            "connect": E_pp,
            "pull": E_pq,
            "push": E_pq[::-1].copy(),
        }
        return x, new_edges, switching_list, extra_events

    # ------------------------------------------------------------------
    def _drop_two_sided(self, E_pp, E_pq, mask):
        """Single cleanup pass over grains left with <= 2 sides
        (models.py:712-722, 745-757 — one scan per call, as the reference)."""
        dropped = []
        live = E_pq[1][E_pq[1] >= 0]
        grains, counts = np.unique(live, return_counts=True)
        for fg in grains[counts <= 2]:
            self._log("removing two-sided grain", int(fg))
            E_pp, E_pq = self._delete_grain(int(fg), E_pp, E_pq, mask)
            dropped.append(int(fg))
        return E_pp, E_pq, dropped

    def _delete_grain(self, grain: int, E_pp, E_pq, mask):
        """models.delete_grain_index (:866-898). Returns (E_pp, E_pq): the
        reconnection edge is APPENDED (new columns) exactly as the reference
        does — freed columns stay -1 so pending L1/L2 edge indices that
        pointed at deleted edges keep referring to dead slots, never to new
        edges."""
        Np = E_pq[0][E_pq[1] == grain]
        if len(Np) != 2:
            self._log("delete_grain: grain", grain, "has", len(Np), "junctions; skipped")
            return E_pp, E_pq
        p1, p2 = int(Np[0]), int(Np[1])
        n1 = E_pp[1][(E_pp[0] == p1) & (E_pp[1] != p2)]
        n2 = E_pp[1][(E_pp[0] == p2) & (E_pp[1] != p1)]
        if len(n1) == 0 or len(n2) == 0:
            return E_pp, E_pq
        np1, np2 = int(n1[0]), int(n2[0])
        E_pp = np.concatenate([E_pp, np.array([[np1, np2], [np2, np1]])], axis=1)
        mask["grain"][grain] = 0
        mask["joint"][p1] = 0
        mask["joint"][p2] = 0
        E_pq[:, E_pq[1] == grain] = -1
        for joint in (p1, p2):
            E_pq[:, E_pq[0] == joint] = -1
            E_pp[:, E_pp[0] == joint] = -1
            E_pp[:, E_pp[1] == joint] = -1
        return E_pp, E_pq

    # ------------------------------------------------------------------
    def _switch_edges(self, E_pp, E_pq, x, y, edge_list, elim_grain, active_joints):
        """models.switching_edge_index (:901-1053): rewires 2 jj + 2 jg edges
        per event and repositions the two junctions at their midpoint."""
        force_elim: List[int] = []
        if len(edge_list) == 0:
            return force_elim
        pairs = np.unique(E_pp.T[np.asarray(edge_list, dtype=np.int64)].reshape(-1))
        xj = x["joint"]
        yj = np.asarray(y["joint"])
        for p in pairs:
            p = int(p)
            xj[p, :2] -= yj[p] / JOINT_SCALE

        for index in range(len(edge_list)):
            e = edge_list[index]
            p1, p2 = int(E_pp[0, e]), int(E_pp[1, e])
            if p1 < 0 or p2 < 0:
                continue
            if not (active_joints[p1] and active_joints[p2]):
                continue

            p1_qn_index = np.nonzero(E_pq[0] == p1)[0]
            p1_qn = E_pq[1][p1_qn_index]
            p2_qn_index = np.nonzero(E_pq[0] == p2)[0]
            p2_qn = E_pq[1][p2_qn_index]

            p1_pn_index = np.nonzero((E_pp[0] == p1) & (E_pp[1] != p2))[0]
            p1_pn = E_pp[1][p1_pn_index]
            p2_pn_index = np.nonzero((E_pp[0] == p2) & (E_pp[1] != p1))[0]
            p2_pn = E_pp[1][p2_pn_index]

            in_p2 = np.isin(p1_qn, p2_qn)
            in_p1 = np.isin(p2_qn, p1_qn)
            expand_q1 = p1_qn[~in_p2]
            expand_q2 = p2_qn[~in_p1]
            shared = p1_qn[in_p2]
            if len(shared) != 2 or len(expand_q1) != 1 or len(expand_q2) != 1:
                self._log("switch skipped: unexpected neighborhood at", (p1, p2))
                continue
            shrink_q1, shrink_q2 = int(shared[0]), int(shared[1])
            expand_q1, expand_q2 = int(expand_q1[0]), int(expand_q2[0])

            p1_qn_sort = (
                [p1_qn_index[i] for i in range(len(p1_qn)) if p1_qn[i] == shrink_q1]
                + [p1_qn_index[i] for i in range(len(p1_qn)) if p1_qn[i] == shrink_q2]
            )
            p2_qn_sort = (
                [p2_qn_index[i] for i in range(len(p2_qn)) if p2_qn[i] == shrink_q1]
                + [p2_qn_index[i] for i in range(len(p2_qn)) if p2_qn[i] == shrink_q2]
            )

            # order joint neighbors so index 0 borders shrink_q1
            p1_pn, p1_pn_index = list(p1_pn), list(p1_pn_index)
            if len(np.nonzero((E_pq[0] == p1_pn[0]) & (E_pq[1] == shrink_q1))[0]) == 0:
                p1_pn.reverse()
                p1_pn_index.reverse()
            p2_pn, p2_pn_index = list(p2_pn), list(p2_pn_index)
            if len(np.nonzero((E_pq[0] == p2_pn[0]) & (E_pq[1] == shrink_q1))[0]) == 0:
                p2_pn.reverse()
                p2_pn_index.reverse()

            sq1_p1, sq2_p1 = int(p1_pn[0]), int(p1_pn[1])
            sq1_p2, sq2_p2 = int(p2_pn[0]), int(p2_pn[1])

            if elim_grain is None and (sq1_p1 == sq1_p2 or sq2_p1 == sq2_p2):
                continue
            if sq1_p1 == sq1_p2 and shrink_q1 != elim_grain:
                force_elim.append(shrink_q1)
            if sq2_p1 == sq2_p2 and shrink_q2 != elim_grain:
                force_elim.append(shrink_q2)

            # reposition the pair at their periodic midpoint (:985-992)
            x_p1 = xj[p1, :2].copy()
            x_p2 = xj[p2, :2].copy()
            x_p2_m = _periodic_move_np(x_p2, x_p1)
            c = 0.5 * (x_p1 + x_p2_m)
            xj[p1, :2] = c
            xj[p2, :2] = _periodic_move_np(c, x_p2)

            swap = point_in_triangle(xj[p2, :2], xj[p1, :2], xj[sq1_p1, :2], xj[sq1_p2, :2])

            # lookahead disambiguation against the remaining events (:1005-1013)
            nxt = set(
                int(v) for v in E_pp.T[np.asarray(edge_list[index:], dtype=np.int64)].reshape(-1)
            )
            if sq1_p2 in nxt and sq2_p2 not in nxt:
                swap = False
            if sq2_p2 in nxt and sq1_p2 not in nxt:
                swap = True
            if sq1_p1 in nxt and sq2_p1 not in nxt:
                swap = True
            if sq2_p1 in nxt and sq1_p1 not in nxt:
                swap = False

            if swap:
                p1_qn_sort.reverse()
                p2_qn_sort.reverse()
                p1_pn_index.reverse()
                p2_pn_index.reverse()
                sq1_p1, sq2_p1 = sq2_p1, sq1_p1
                sq1_p2, sq2_p2 = sq2_p2, sq1_p2

            # rewire jg edges
            E_pq[1, p1_qn_sort[1]] = expand_q2
            E_pq[1, p2_qn_sort[0]] = expand_q1
            # rewire jj edges
            E_pp[0, p1_pn_index[1]] = p2
            E_pp[0, p2_pn_index[0]] = p1
            E_pp[1, (E_pp[0] == sq1_p2) & (E_pp[1] == p2)] = p1
            E_pp[1, (E_pp[0] == sq2_p1) & (E_pp[1] == p1)] = p2

        # models.py:906-908,1048-1050: the reference's save_prev binds a
        # torch VIEW of the joint row, so its displacement rewrite
        # y = scale*(x - save_prev) is identically ZERO for every junction in
        # `pairs` — touched junctions leave the call with y == 0 and zeroed
        # grad features. Verified empirically (torch basic indexing returns
        # views); scripts/ab_stepwise.py isolated this as the only
        # cross-implementation divergence on seed10020.
        for p in pairs:
            p = int(p)
            yj[p] = 0.0
            xj[p, 6:8] = 0.0
        y["joint"] = yj
        return force_elim

    # ------------------------------------------------------------------
    def _nucleate(self, x, mask, E_pp, E_pq, nucleation_prob):
        """models.py:769-837: insert one grain + two junctions at random
        live junction sites."""
        rand = self.rng.random(len(x["joint"]))
        sites = np.nonzero((rand < nucleation_prob) & (mask["joint"][:, 0] > 0))[0]
        num_grains = len(mask["grain"])
        num_junctions = len(mask["joint"])

        for junction in sites:
            junction = int(junction)
            self._log("nucleation at junction", junction, "grain", num_grains)
            mask["joint"] = np.concatenate([mask["joint"], [[1], [1]]])
            mask["grain"] = np.concatenate([mask["grain"], [[1]]])

            site = x["joint"][junction]
            site_x, site_y, site_z = site[0], site[1], site[2]
            delta_z = site[-1]
            theta_x, theta_z = self.rng.random(2) * math.pi / 2
            area0 = 0.004
            edge_len = math.sqrt(area0 * 4 / 3 / math.sqrt(3))
            new_grain = np.array([
                site_x, site_y, site_z, area0, 0,
                math.cos(theta_x), math.sin(theta_x),
                math.cos(theta_z), math.sin(theta_z), area0, delta_z,
            ])
            x["grain"] = np.concatenate([x["grain"], new_grain[None, :]], axis=0)

            new_j1, new_j2 = num_junctions, num_junctions + 1
            j_nbrs = E_pp[1, E_pp[0] == junction]
            j_nb0, j_nb1, j_nb2 = (int(j) for j in j_nbrs[:3])
            grain_nbrs = E_pq[1, E_pq[0] == junction]
            ordered = [0, 0, 0]
            for gn in grain_nbrs:
                gn = int(gn)
                if len(np.nonzero((E_pq[0] == j_nb0) & (E_pq[1] == gn))[0]) == 0:
                    ordered[0] = gn
                if len(np.nonzero((E_pq[0] == j_nb1) & (E_pq[1] == gn))[0]) == 0:
                    ordered[1] = gn
                if len(np.nonzero((E_pq[0] == j_nb2) & (E_pq[1] == gn))[0]) == 0:
                    ordered[2] = gn
            gr0, gr1, gr2 = ordered
            assert gr0 != gr1 and gr1 != gr2 and gr0 != gr2

            center = x["joint"][junction, :2].copy()
            v1 = x["joint"][junction].copy()
            v2 = x["joint"][junction].copy()
            x["joint"][junction, :2] = center + _unit_np(x["joint"][j_nb0, :2], center) * edge_len
            v1[:2] = center + _unit_np(x["joint"][j_nb1, :2], center) * edge_len
            v2[:2] = center + _unit_np(x["joint"][j_nb2, :2], center) * edge_len
            x["joint"][junction, -2:] = 0
            v1[-2:] = 0
            v2[-2:] = 0
            x["joint"] = np.concatenate([x["joint"], v1[None, :], v2[None, :]], axis=0)

            E_pq[:, E_pq[0] == junction] = -1
            E_pp[1, (E_pp[0] == j_nb1) & (E_pp[1] == junction)] = new_j1
            E_pp[1, (E_pp[0] == j_nb2) & (E_pp[1] == junction)] = new_j2
            E_pp[0, (E_pp[0] == junction) & (E_pp[1] == j_nb1)] = new_j1
            E_pp[0, (E_pp[0] == junction) & (E_pp[1] == j_nb2)] = new_j2

            E_pp = np.concatenate([E_pp, np.array([
                [junction, junction, new_j1, new_j1, new_j2, new_j2],
                [new_j1, new_j2, junction, new_j2, junction, new_j1],
            ])], axis=1)
            E_pq = np.concatenate([E_pq, np.array([
                [junction, new_j1, new_j2, new_j1, new_j2, junction, new_j2, junction, new_j1],
                [num_grains, num_grains, num_grains, gr0, gr0, gr1, gr1, gr2, gr2],
            ])], axis=1)
            num_grains += 1
            num_junctions += 2
        return x, mask, E_pp, E_pq
