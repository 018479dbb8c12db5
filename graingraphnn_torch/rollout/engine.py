"""The host rollout engine (reference test.py:72-611): the CLI's default
rollout, with the modes the device-resident rollout leaves out (no-flux
boundary, temporal (G, R), interpolated frames, ensembles, the host or
device editor, the comparison with a phase-field truth).

Per span (z layer):
  <1> the regressor and classifier forwards on the padded sample, on the
      card through the hand kernels (kernels=True, no autograd);
  <2> feature integration (Rmodel.update, models.py:473-527), the z
      advance and, with a moving melt pool, its active window;
  <3> elimination candidates and the topology edit: the float64 host
      editor (rollout.topology), or with jit_editor the editor kernel
      (kernels.editor_fused) and the nucleation pass on the card;
  <4> the planar graph rebuilt from the junction incidence and
      rasterised, the layer error and event hits against the truth;
  <5> grain centers and edge lengths for the next span.

The state lives on the host in float64 numpy between spans; each span
moves the sample to the card and the predictions back. The sample is
padded to bucketed capacities and a pull ring sized from the live
degree, as the JAX package pads it, so the kernels see shapes that
change from span to span.
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Sequence, Union

import numpy as np
import torch
from torch import nn

from ..graph import schema
from ..graph import state as gstate
from ..graph.planar import PlanarGraph
from ..kernels import editor_fused
from . import topology_jit as tj
from .qoi import (
    event_hit_rate,
    misorientation_curve,
    size_distribution_ks,
    volume_graph,
    volume_truth,
)
from .topology import TopologyEditor

TRAIN_FRAMES = 120       # frames of a training trajectory
TRAIN_DELTA_Z = 0.4      # layer height of one frame

Models = Union[nn.Module, Sequence[nn.Module]]


def _pad_rows(a, n, fill=0.0):
    if n == 0:
        return a
    out = np.full((len(a) + n,) + a.shape[1:], fill, a.dtype)
    out[: len(a)] = a
    return out


class RolloutEngine:
    """The rollout of one starting graph with a regressor and a classifier
    (each an nn.Module, or a list of them: a deep ensemble) on `device`.

    An ensemble regressor predicts the member mean. The classifier's
    edge_event is a logit, sigmoided only by the editor, so an ensemble
    classifier averages the members' probabilities and turns the mean back
    into a logit: c_threshold keeps its single-model calibration. One
    numpy Generator, default_rng(seed), held by the host editor, draws the
    nucleation sites and orientations of both editors.

    halo = (mesh, D): both forwards split over the D ranks of a
    parallel.mesh.launch with halo-exchange stripes (parallel.halo), the
    stripes rebuilt from the moved positions each span; the editor stays
    whole on every rank. Call run on every rank; each returns the same
    result. Periodic boundary and single models only."""

    def __init__(
        self,
        regressor: Models,
        classifier: Models,
        *,
        r_threshold: float = 1e-4,
        c_threshold: float = 0.6,
        seed: int = 0,
        verbose: bool = False,
        jit_editor: bool = False,
        halo: Optional[tuple] = None,
        device="cuda",
    ):
        self._ens_r = isinstance(regressor, (list, tuple))
        self._ens_c = isinstance(classifier, (list, tuple))
        self._halo_span = self._halo_D = None
        if halo is not None:
            from ..parallel.halo import make_halo_span_forward

            if self._ens_r or self._ens_c:
                raise ValueError("the halo rollout takes single models, "
                                 "not ensembles")
            mesh, self._halo_D = halo[0], halo[1]
            device = mesh.device
        self.device = torch.device(device)
        self.regressors = [m.to(self.device).eval() for m in
                           (regressor if self._ens_r else [regressor])]
        self.classifiers = [m.to(self.device).eval() for m in
                            (classifier if self._ens_c else [classifier])]
        self.r_threshold = r_threshold
        self.c_threshold = c_threshold
        self.jit_editor = jit_editor
        self.editor = TopologyEditor(
            threshold=c_threshold, rng=np.random.default_rng(seed),
            verbose=verbose)
        self.verbose = verbose
        if halo is not None:
            self._halo_span = make_halo_span_forward(
                self.regressors[0], self.classifiers[0], halo[0])

    def _log(self, *a):
        if self.verbose:
            print(*a)

    # ------------------------------------------------------------------
    def _jit_update(self, x, edges, pred, mask, nucleation_prob=0.0,
                    active_grains=None, active_joints=None):
        """The span's edit on the device: the editor kernel (the plain
        editor for a CPU engine) on the packed state, then the nucleation
        pass with draws from the host editor's rng, in the host editor's
        order (editor, then nucleation). The packed widths keep the JAX
        package's slack and 64-column buckets."""
        nuc = nucleation_prob > 1e-6
        NG, NJ = len(x["grain"]), len(x["joint"])
        pad_g = tj.MAX_NUC if nuc else 0
        pad_j = 2 * tj.MAX_NUC if nuc else 0
        dev = self.device

        def on_dev(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a)).to(
                device=dev, dtype=dtype)

        E_base = edges["connect"]
        slack = 2 * (tj.MAX_ELIM * 3 + tj.MAX_TWOSIDED + 2) + 6 * pad_g
        EP = gstate.round_up(E_base.shape[1] + slack, 64)
        E_pp = np.full((2, EP), -1, np.int64)
        E_pp[:, : E_base.shape[1]] = E_base
        EQ_base = edges["pull"].shape[1]
        EQ = gstate.round_up(EQ_base + 9 * pad_g, 64) if nuc else EQ_base
        E_pq = np.full((2, EQ), -1, np.int64)
        E_pq[:, :EQ_base] = edges["pull"]

        xj = _pad_rows(np.asarray(x["joint"], np.float64), pad_j)
        yj = _pad_rows(np.asarray(pred["joint"], np.float64), pad_j)
        active_j = None
        if active_joints is not None:
            active_j = on_dev(_pad_rows(np.asarray(active_joints), pad_j),
                              torch.int32)
        state = tj.TopoState(
            E_pp=on_dev(E_pp, torch.int32),
            E_pq=on_dev(E_pq, torch.int32),
            xj=on_dev(xj, torch.float32),
            y_joint=on_dev(yj, torch.float32),
            mask_g=on_dev(_pad_rows(mask["grain"][:, 0], pad_g), torch.int32),
            mask_j=on_dev(_pad_rows(mask["joint"][:, 0], pad_j), torch.int32),
            append_ptr=torch.tensor(E_base.shape[1], dtype=torch.int32,
                                    device=dev),
            active_j=active_j,
            q_ptr=(torch.tensor(EQ_base, dtype=torch.int32, device=dev)
                   if nuc else None),
        )
        logits = np.full(EP, -1e30, np.float32)
        logits[: E_base.shape[1]] = pred["edge_event"]
        ge = np.full(tj.MAX_ELIM, -1, np.int32)
        ev = np.asarray(pred["grain_event"])[: tj.MAX_ELIM]
        ge[: len(ev)] = ev
        active_g = None
        if active_grains is not None:
            active_g = on_dev(_pad_rows(np.asarray(active_grains), pad_g),
                              torch.int32)
        # y_grain padded to the state's grain rows, which the kernel
        # requires; the editor reads only the rows of grains below NG
        state2, switching, extra = editor_fused.update_fused(
            state, on_dev(logits, torch.float32), on_dev(ge, torch.int32),
            on_dev(_pad_rows(np.asarray(pred["grain"]), pad_g),
                   torch.float32), self.c_threshold, NG, active_g=active_g)

        # the nucleation pass: the host editor's rng stream
        if nuc:
            rng = self.editor.rng
            rand = rng.random(NJ)
            mask_j_now = state2.mask_j[:NJ].cpu().numpy()
            n_sites = int(((rand < nucleation_prob) & (mask_j_now > 0)).sum())
            angles = np.zeros((tj.MAX_NUC, 2))
            if n_sites:
                angles[:n_sites] = rng.random((min(n_sites, tj.MAX_NUC), 2))
            xg = _pad_rows(np.asarray(x["grain"], np.float64), pad_g)
            state2, xg_out, n_g2, n_j2, _ = tj.nucleate_jit(
                state2, on_dev(xg, torch.float32),
                torch.tensor(NG, dtype=torch.int32, device=dev),
                torch.tensor(NJ, dtype=torch.int32, device=dev),
                on_dev(_pad_rows(rand, pad_j, fill=1.0), torch.float32),
                on_dev(angles, torch.float32), float(nucleation_prob))
            n_g2, n_j2 = int(n_g2), int(n_j2)
            x["grain"] = xg_out.cpu().numpy().astype(np.float64)[:n_g2]
            mask["grain"] = state2.mask_g[:n_g2, None].cpu().numpy()
        else:
            n_g2, n_j2 = NG, NJ
            mask["grain"][:, 0] = state2.mask_g[:NG].cpu().numpy()

        # back to the host layout, deleted columns compacted
        E_pp2 = state2.E_pp.cpu().numpy()
        E_pq2 = state2.E_pq.cpu().numpy()
        new_edges = {
            "connect": E_pp2[:, E_pp2[0] >= 0].astype(np.int64),
            "pull": E_pq2[:, E_pq2[0] >= 0].astype(np.int64),
        }
        new_edges["push"] = new_edges["pull"][::-1].copy()
        x["joint"] = state2.xj.cpu().numpy().astype(np.float64)[:n_j2]
        if nuc:
            mask["joint"] = state2.mask_j[:n_j2, None].cpu().numpy()
        else:
            mask["joint"][:, 0] = state2.mask_j[:NJ].cpu().numpy()
        switching = switching.cpu().numpy()
        switching = switching[switching[:, 0] >= 0]
        extra = extra.cpu().numpy()
        extra = extra[extra >= 0].astype(np.int64)
        return x, new_edges, switching, extra

    # ------------------------------------------------------------------
    def _sample(self, x, edges, edge_attr, caps):
        """The padded sample on the host at capacities caps = (grains,
        joints, jj edges), with grain 0's edges left out under the no-flux
        boundary and the pull ring sized from the live degree."""
        ng, nj, ne = caps
        push, pull = edges["push"], edges["pull"]
        attr = dict(edge_attr)
        if self._bc == "noflux":
            # the boundary grain (id 0) has an unbounded, unphysical ring
            # (test.py:365-375)
            keep_p = push[0] > 0
            keep_q = pull[1] > 0
            attr = {
                schema.EDGE_TYPES[0]: edge_attr[schema.EDGE_TYPES[0]][keep_p],
                schema.EDGE_TYPES[1]: edge_attr[schema.EDGE_TYPES[1]][keep_q],
                schema.EDGE_TYPES[2]: edge_attr[schema.EDGE_TYPES[2]],
            }
            push = push[:, keep_p]
            pull = pull[:, keep_q]
        # grains gain sides as their neighbors are eliminated: the ring
        # grows in 8-wide buckets from the default 16
        live_dst = pull[1][pull[1] >= 0]
        max_ring = int(np.bincount(live_dst).max()) if len(live_dst) else 1
        ring = max(schema.DEFAULT_GRAIN_RING, gstate.round_up(max_ring, 8))
        return gstate.build_sample(
            {"grain": x["grain"], "joint": x["joint"]},
            {schema.EDGE_TYPES[0]: push,
             schema.EDGE_TYPES[1]: pull,
             schema.EDGE_TYPES[2]: edges["connect"]},
            attr,
            {"grain": self._mask["grain"], "joint": self._mask["joint"]},
            device="cpu", grain_cap=ng, joint_cap=nj, jj_edge_cap=ne,
            grain_ring=ring,
        )

    @torch.no_grad()
    def _predict(self, sample):
        """(y_r, y_c): both models' outputs on the sample, on the engine's
        device, ensembles averaged."""
        def mean(outs):
            return {k: torch.stack([o[k] for o in outs]).mean(0)
                    for k in outs[0]}

        y_r = mean([m(sample, kernels=True) for m in self.regressors])
        if not self._ens_c:
            return y_r, self.classifiers[0](sample, kernels=True)
        outs = []
        for m in self.classifiers:
            y = m(sample, kernels=True)
            outs.append({**y, "edge_event": torch.sigmoid(y["edge_event"])})
        y_c = mean(outs)
        pm = torch.clamp(y_c["edge_event"], 1e-7, 1.0 - 1e-7)
        y_c["edge_event"] = torch.log(pm) - torch.log1p(-pm)
        return y_r, y_c

    @staticmethod
    def _to_host(ys):
        return tuple({k: v.cpu().numpy() for k, v in y.items()} for y in ys)

    def _forward(self, x, edges, edge_attr, caps):
        """The forwards on the padded sample: (y_r, y_c) as float32 numpy
        arrays on the host, and the sample on the device. Under `halo`,
        the forwards over the stripes, and no sample."""
        if self._halo_span is not None:
            pred = self._halo_span(
                x, {schema.EDGE_TYPES[0]: edges["push"],
                    schema.EDGE_TYPES[1]: edges["pull"],
                    schema.EDGE_TYPES[2]: edges["connect"]}, edge_attr,
                self._mask, self._halo_D)
            y_r = {k: pred[k] for k in ("joint", "grain", "grain_area")}
            y_c = {k: pred[k] for k in ("edge_event", "edge")}
            return self._to_host((y_r, y_c)), None
        sample = self._sample(x, edges, edge_attr, caps).to(self.device)
        return self._to_host(self._predict(sample)), sample

    # ------------------------------------------------------------------
    def run(
        self,
        hg0,                      # HeteroState: the t=0 sample
        traj,                     # TrajectoryExtractor, truth where compared
        *,
        span: Optional[int] = None,
        compare: bool = True,
        growth_height: float = -1.0,
        reconstruct: bool = True,
        nucleation_density: float = 0.0,
        reconst_mesh_size: float = 0.08,
        temporal: bool = False,
        interp_frames: int = 0,
        collect_fields: bool = False,
        meltpool: Optional[Dict] = None,
        clamp_gr: Optional[tuple] = None,
    ) -> Dict:
        """Roll hg0 from traj's initial height to its final one (or
        growth_height above it) in steps of `span` frames. Returns the
        result dict (times, event counts and hits, layer errors, volumes'
        misorientation, and with compare the size-distribution KS).

        compare=True reads the truth from traj: alpha_pde_frames [x, y, t]
        (the layer error), grain_events, and where given totalV_frames and
        extraV_frames (the KS). meltpool = {r0, z0, melt_pool_angle}: the
        moving melt pool's sliding window (test.py:315-324), which sets the
        number of spans; None for the static line. temporal: a random
        (G, R) schedule by build height (data.thermal). interp_frames:
        rasters blended between spans. clamp_gr = (G_min, G_max, R_min,
        R_max) clamps the thermal features (joint columns 3/4, encoded
        1 - G/10 and R/2) to the training hull."""
        span = span or getattr(hg0, "span", 6)
        t_start = time.time()

        # ---- initialization (test.py:288-347) ----------------------------
        x = {
            "grain": np.array(hg0.feature_dicts["grain"], dtype=np.float64),
            "joint": np.array(hg0.feature_dicts["joint"], dtype=np.float64),
        }
        edges = {
            "push": np.array(hg0.edge_index_dicts[schema.EDGE_TYPES[0]], dtype=np.int64),
            "pull": np.array(hg0.edge_index_dicts[schema.EDGE_TYPES[1]], dtype=np.int64),
            "connect": np.array(hg0.edge_index_dicts[schema.EDGE_TYPES[2]], dtype=np.int64),
        }
        edge_attr = {
            et: np.array(hg0.edge_weight_dicts[et], dtype=np.float64)
            for et in schema.EDGE_TYPES
        }
        # live jj edges only (deleted slots were compacted by append_history)
        live = edges["connect"][0] > -1
        edges["connect"] = edges["connect"][:, live]

        mask = {
            "grain": np.array(hg0.mask["grain"], dtype=np.int64).reshape(-1, 1),
            "joint": np.ones((len(x["joint"]), 1), dtype=np.int64),
        }
        if clamp_gr is not None:
            g_min, g_max, r_min, r_max = clamp_gr
            g = 10.0 * (1.0 - x["joint"][:, 3])
            r = 2.0 * x["joint"][:, 4]
            x["joint"][:, 3] = 1.0 - np.clip(g, g_min, g_max) / 10.0
            x["joint"][:, 4] = np.clip(r, r_min, r_max) / 2.0
        self._mask = mask
        self._bc = traj.BC
        if self._halo_span is not None and traj.BC != "periodic":
            raise ValueError("the halo-partitioned rollout covers the "
                             "periodic boundary")

        # patch rescaling for domains larger than the 40 um training patch
        # (test.py:29-55,310-312): local geometry scaled to the training
        # distribution, per-node offsets folded out for the reconstruction
        domain_factor = traj.lxd / traj.patch_size
        offset_j = np.zeros((len(x["joint"]), 2))
        if domain_factor > 1:
            for et in edge_attr:
                edge_attr[et] = edge_attr[et] * domain_factor
            x["grain"][:, :2] *= domain_factor
            x["joint"][:, :2] *= domain_factor
            offset_j = np.floor(x["joint"][:, :2])
            x["joint"][:, :2] -= offset_j
            if traj.BC == "periodic":
                off_g = x["grain"][:, :2] - x["grain"][:, :2] % 1
            else:
                off_g = np.floor(x["grain"][:, :2])
            x["grain"][:, :2] -= off_g

        # planar bookkeeping graph for the reconstruction and the QoIs
        pg = PlanarGraph(bc=traj.BC, imagesize=traj.imagesize)
        pg.raise_err = False
        pg.max_y = getattr(traj, "max_y", 1.0)
        num_regions = traj.num_regions
        theta_z = np.array(traj.theta_z)

        area_traj = [dict(traj.area_traj[0])] if traj.area_traj else [{}]
        extraV_traj = []

        imagesize = (
            (int(traj.lxd / reconst_mesh_size) + 1,
             int(traj.lyd / reconst_mesh_size) + 1)
            if reconstruct else (0, 0)
        )

        s_full = traj.patch_size / traj.mesh_size + 1

        def to_global(X):
            """Patch offsets folded out for the reconstruction
            (test.py:471-474)."""
            if domain_factor <= 1:
                return X
            Xg = {k: v.copy() for k, v in X.items()}
            n = len(offset_j)
            Xg["joint"][:n, :2] = (Xg["joint"][:n, :2] + offset_j) / domain_factor
            return Xg

        def gnn_update(frame, X, topo):
            """graph_trajectory.GNN_update (:1010-1103)."""
            X = to_global(X)
            X_j = X["joint"][:, :2]
            X_g = X["grain"][:, 3:5]
            mask_j = mask["joint"][:, 0]
            mask_g = mask["grain"][:, 0]
            pg.vertices = {
                i: X_j[i].tolist() for i in range(len(X_j)) if mask_j[i] == 1
            }
            area_counts = {}
            area_sum = np.sum(X_g[:, 0] * mask_g) / (traj.lxd / traj.patch_size) ** 2
            for idx in range(len(X_g)):
                if mask_g[idx] > 0:
                    area_counts[idx + 1] = X_g[idx, 0] * s_full**2 / area_sum
            extraV_traj.append(
                mask_g * X_g[:, 1] / schema.TARGET_SCALING["grain"] * s_full**3)
            if frame > 0:
                area_traj.append(area_counts)
            else:
                area_traj[0] = area_counts
            if topo:
                v2j = {}
                for grain, joint in edges["push"].T:
                    v2j.setdefault(int(joint), set()).add(int(grain) + 1)
                for k, v in v2j.items():
                    assert len(v) == 3, (k, v)
                pg.joint2vertex = {tuple(sorted(v)): k for k, v in v2j.items()}
                pg.vertex2joint = {v: k for k, v in pg.joint2vertex.items()}
                pg.edges = [[int(i), int(j)] for i, j in edges["connect"].T]
            pg.rebuild_regions()
            return area_counts

        if growth_height > 0:
            final_height = traj.ini_height + growth_height
        else:
            final_height = traj.final_height
        frames_total = int((final_height - traj.ini_height) / TRAIN_DELTA_Z) + 1
        frame_ratio = getattr(traj, "train_test_frame_ratio", 1)

        # moving melt pool (test.py:315-324): a sliding active window whose
        # width follows the melt-front slope; the frame budget is the
        # number of window advances that fit in the domain
        melt = None
        if meltpool is not None:
            angle = meltpool["melt_pool_angle"]
            gap = span * TRAIN_DELTA_Z * np.cos(angle) ** 2 / np.tan(angle) / traj.lxd
            win = (meltpool["r0"] - meltpool["z0"]) / np.tan(angle) / traj.lxd
            melt = {
                "r0": meltpool["r0"], "z0": meltpool["z0"], "gap": gap,
                "melt_left": 0.0, "melt_right": win, "melt_extra": win + gap,
            }
            frames_total = int(np.floor((1 - win) / gap)) * span + 1

        # temporal mode: a varying (G, R) schedule by build height
        # (test.py:345-346,377-379, graph_trajectory.GR_seq_from_time)
        g_list = r_list = None
        if temporal:
            from ..data.thermal import gr_sequence_from_time

            g_list, r_list = gr_sequence_from_time(
                traj.seed, 2 ** (traj.seed % 10), TRAIN_DELTA_Z * span,
                (frames_total - 1) // span, traj.ini_height, final_height,
            )

        gnn_update(0, x, topo=True)
        alpha_field_list = []
        if reconstruct:
            pg.rasterize(imagesize)
            if collect_fields:
                alpha_field_list.append(pg.alpha_field.T.copy())
        prev_X = {k: v.copy() for k, v in x.items()}
        layer_err_list = []
        if compare:
            pg.layer_error(traj.alpha_pde_frames[:, :, 0].T)
            layer_err_list.append((traj.ini_height, pg.error_layer))

        grain_event_list: list = []
        event_steps: list = []
        grain_acc_list = [(traj.ini_height, 0, 0, 0)]
        grain_events_truth = (traj.grain_events if traj.grain_events
                              else [set()] * frames_total)

        # padded capacities
        def caps():
            return (
                gstate.round_up(len(x["grain"]), 8),
                gstate.round_up(len(x["joint"]), 16),
                gstate.round_up(edges["connect"].shape[1], 32),
            )

        # ---- the rollout loop (test.py:353-577) -------------------------
        for frame in range(span, frames_total, span):
            self._log(f"--- progress {frame/(frames_total-1):1.2f} ---")
            height = traj.ini_height + frame * TRAIN_DELTA_Z

            # <1> forward
            if temporal:
                g_now = g_list[frame // span - 1]
                r_now = r_list[frame // span - 1]
                if clamp_gr is not None:
                    g_now = np.clip(g_now, clamp_gr[0], clamp_gr[1])
                    r_now = np.clip(r_now, clamp_gr[2], clamp_gr[3])
                x["joint"][:, 3] = 1 - g_now / 10
                x["joint"][:, 4] = r_now / 2
            (y_r, y_c), _sample = self._forward(
                {k: v.astype(np.float32) for k, v in x.items()}, edges,
                edge_attr, caps())
            ng, nj = len(x["grain"]), len(x["joint"])
            ne = edges["connect"].shape[1]
            pred = {
                "joint": np.asarray(y_r["joint"], np.float64)[:nj],
                "grain": np.asarray(y_r["grain"], np.float64)[:ng],
                "grain_area": np.asarray(y_r["grain_area"], np.float64)[:ng],
                "edge_event": np.asarray(y_c["edge_event"], np.float64)[:ne],
                "edge": np.asarray(y_c["edge"], np.float64)[:ne],
            }

            # <2> feature integration (models.Rmodel.update, :473-527)
            active_joints = active_grains = None
            if melt is not None:
                # moving-meltpool active window (models.py:480-507): only
                # nodes inside the window evolve; predictions near its
                # trailing edge are tapered and scaled by front curvature
                n_off = len(offset_j)
                gx_j = (x["joint"][:n_off, :2] + offset_j) / max(domain_factor, 1)
                gx_g = x["grain"][:, :2] / max(domain_factor, 1)

                def window(xc):
                    near = (xc - melt["melt_extra"]) / (
                        melt["melt_right"] - melt["melt_extra"]
                    )
                    near = np.clip(near, 0.0, 1.0)
                    near[xc < melt["melt_left"]] = 0.0
                    return near

                def curvature(xc):
                    return melt["z0"] + (melt["r0"] - melt["z0"]) * (
                        xc - melt["melt_left"]
                    ) / (melt["melt_right"] - melt["melt_left"])

                aw_j = np.zeros(len(x["joint"]))
                aw_j[:n_off] = window(gx_j[:, 0])
                aw_g = window(gx_g[:, 0])
                pred["joint"] = pred["joint"] * aw_j[:, None]
                pred["joint"][:n_off, 1] *= melt["r0"] / curvature(gx_j[:, 0])
                pred["grain"][:, 0] *= aw_g * melt["r0"] / curvature(gx_g[:, 0])
                pred["grain"][:, 1] *= aw_g
                active_joints = aw_j > 0.9999
                active_grains = aw_g > 0.9999

            x["joint"][:, :2] += pred["joint"] / schema.TARGET_SCALING["joint"]
            x["grain"][:, schema.GRAIN_AREA_COL] += (
                pred["grain"][:, 0] / schema.TARGET_SCALING["grain"]
            )
            x["grain"][:, schema.GRAIN_EXTRAV_COL] = pred["grain"][:, 1]
            x["joint"][:, 6:8] = pred["joint"]
            x["grain"][:, schema.GRAIN_DAREA_COL] = pred["grain"][:, 0]
            # z advance and clamp (test.py:401-407)
            x["grain"][:, 2] += span / (TRAIN_FRAMES + 1)
            x["joint"][:, 2] += span / (TRAIN_FRAMES + 1)
            zmax = TRAIN_FRAMES / (TRAIN_FRAMES + 1)
            if x["grain"][0, 2] > zmax:
                x["grain"][:, 2] = zmax
                x["joint"][:, 2] = zmax

            # <3> events and topology edits
            live_g = mask["grain"][:, 0] > 0
            cand = np.nonzero(live_g & (pred["grain_area"] < self.r_threshold))[0]
            cand = cand[np.argsort(pred["grain_area"][cand])]
            if traj.BC == "noflux":
                cand = cand[cand != 0]
            pred["grain_event"] = cand

            nucleation_prob = (
                nucleation_density * traj.lxd * traj.lxd * TRAIN_DELTA_Z
                / max(int(mask["joint"].sum()), 1)
            )
            if melt is not None:
                # the editor honors the active window (models.py:641-648,912)
                cand = cand[active_grains[cand]]
                pred["grain_event"] = cand
            edit = self._jit_update if self.jit_editor else self.editor.update
            x, edges, switching_list, extra_events = edit(
                x, edges, pred, mask, nucleation_prob=nucleation_prob,
                active_grains=active_grains, active_joints=active_joints,
            )
            pred["grain_event"] = np.concatenate([pred["grain_event"], extra_events])

            # no-flux boundary (test.py:446-466): reset the boundary grain,
            # snap boundary joints to the wall, clamp coordinates
            if traj.BC == "noflux":
                x["grain"][0, :2] = 0.5
                x["grain"][0, 3:5] = 0
                x["grain"][0, -1] = 0
                n_off = len(offset_j)
                xj = x["joint"]
                xj[:n_off, :2] = (xj[:n_off, :2] + offset_j) / max(domain_factor, 1)
                max_y = getattr(traj, "max_y", 1.0)
                bnd = np.unique(edges["push"][1, edges["push"][0] == 0])
                for p in bnd:
                    d = np.array([xj[p, 0], 1.0 - xj[p, 0], xj[p, 1], max_y - xj[p, 1]])
                    side = int(np.argmin(d))
                    xj[p, [0, 0, 1, 1][side]] = [0.0, 1.0, 0.0, max_y][side]
                xj[:, 0] = np.clip(xj[:, 0], 0.0, 1.0)
                xj[:, 1] = np.clip(xj[:, 1], 0.0, max_y)
                if domain_factor > 1:
                    xj[:n_off, :2] = xj[:n_off, :2] * domain_factor - offset_j

            if len(x["grain"]) > num_regions:
                add_angles = np.arccos(x["grain"][num_regions:, 5])
                theta_z = np.concatenate([theta_z, add_angles])
                num_regions = len(x["grain"])

            grain_event_list.extend(int(g) for g in pred["grain_event"])
            # calibration breakdown: area-triggered and editor-forced events
            event_steps.append({
                "height": float(height),
                "area_elim": int(len(cand)),
                "forced_elim": int(len(extra_events)),
                "switches": int(len(switching_list)),
            })
            topo = len(pred["grain_event"]) > 0 or len(switching_list) > 0

            # <4> reconstruction and evaluation
            gnn_update(frame, x, topo)
            truth_frames = grain_events_truth[: frame // frame_ratio + 1]
            truth = set()
            for s_ in truth_frames:
                truth |= set(s_)
            truth = {int(i) - 1 for i in truth}
            tp, n_truth, n_pred = event_hit_rate(set(grain_event_list), truth)
            grain_acc_list.append((height, n_truth, n_pred, tp))
            self._log(f"grain events hit rate: {tp}/{n_truth} (predicted {n_pred})")

            if reconstruct:
                # interpolated layers for smoother 3D stacks (test.py:494-528):
                # joint coordinates blended between the previous span and
                # this one
                for k in range(interp_frames):
                    coeff = (1 + k) / (1 + interp_frames)
                    mean_x = {kk: v.copy() for kk, v in x.items()}
                    n_prev = min(len(prev_X["joint"]), len(mean_x["joint"]))
                    mean_x["joint"][:n_prev, :2] = (
                        coeff * x["joint"][:n_prev, :2]
                        + (1 - coeff) * prev_X["joint"][:n_prev, :2]
                    )
                    gnn_update(frame, mean_x, topo=False)
                    pg.rasterize(imagesize)
                    if collect_fields:
                        alpha_field_list.append(pg.alpha_field.T.copy())
                if interp_frames:
                    gnn_update(frame, x, topo=False)
                pg.rasterize(imagesize)
                if collect_fields:
                    alpha_field_list.append(pg.alpha_field.T.copy())
            if compare:
                t_idx = frame // frame_ratio
                t_idx = min(t_idx, traj.alpha_pde_frames.shape[2] - 1)
                pg.layer_error(traj.alpha_pde_frames[:, :, t_idx].T)
                layer_err_list.append((height, pg.error_layer))
                self._log(f"layer error {pg.error_layer:.4f}")
            prev_X = {k: v.copy() for k, v in x.items()}

            if melt is not None:
                # advance the sliding window (test.py:551-554)
                melt["melt_left"] += melt["gap"]
                melt["melt_right"] += melt["gap"]
                melt["melt_extra"] += melt["gap"]

            # <5> next-step inputs: grain centers and fresh edge lengths
            for grain, coor in pg.region_center.items():
                if domain_factor > 1:
                    x["grain"][grain - 1, :2] = (
                        np.asarray(coor) * domain_factor
                    ) % 1  # test.py:556-559
                else:
                    x["grain"][grain - 1, :2] = coor
            edge_attr = {}
            for et, key in ((schema.EDGE_TYPES[0], "push"),
                            (schema.EDGE_TYPES[1], "pull"),
                            (schema.EDGE_TYPES[2], "connect")):
                e = edges[key]
                src_t, dst_t = et[0], et[-1]
                src_x = x[src_t][e[0], :2]
                dst_x = x[dst_t][e[1], :2]
                rel = src_x - dst_x
                rel += -1.0 * (rel > 0.5) + 1.0 * (rel < -0.5)
                edge_attr[et] = np.sqrt(np.sum(rel**2, axis=1))[:, None]

        elapsed = time.time() - t_start

        # ---- final QoIs (test.py:584-601) -------------------------------
        result = {
            "inference_time": elapsed,
            "alpha_field_list": alpha_field_list if collect_fields else None,
            "grain_acc_list": grain_acc_list,
            "layer_err_list": layer_err_list,
            "final_layer_error": layer_err_list[-1][1] if layer_err_list else None,
            "mean_layer_error": (float(np.mean([e for _, e in layer_err_list]))
                                 if layer_err_list else None),
            "events_tp": grain_acc_list[-1][3],
            "events_truth": grain_acc_list[-1][1],
            "events_pred": grain_acc_list[-1][2],
            "num_grains_final": len(x["grain"]),
            "num_grains_live": int((mask["grain"][:, 0] > 0).sum()),
            "event_steps": event_steps,
        }
        delta_h = (
            (final_height - traj.ini_height) / traj.mesh_size / (frames_total - 1) * span
        )
        vol_pred = volume_graph(area_traj, extraV_traj, num_regions, delta_h)
        result["misorientation"] = misorientation_curve(theta_z, vol_pred)
        if compare and hasattr(traj, "totalV_frames"):
            vol_truth = volume_truth(
                traj.totalV_frames, traj.extraV_frames, span, frames_total,
                traj.ini_height, final_height, traj.mesh_size,
                traj.imagesize[0], frame_ratio,
            )
            ks, p, err_mu = size_distribution_ks(
                vol_pred[-1], vol_truth[-1], traj.mesh_size
            )
            result.update({"KS": ks, "KS_p": p, "size_err": err_mu})
        return result
