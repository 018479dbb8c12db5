"""Heterograph tensorization and training-label formation (numpy).

`HeteroState` holds the feature, target and edge dicts of one
cross-section; `tensorize` builds it from a planar-graph snapshot,
`form_gradient` adds the targets and event labels of the next window and
the gradient features of the previous one, and `append_history` appends
earlier gradient columns.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..graph import schema
from ..graph.planar import periodic_dist_pt

PUSH, PULL, CONNECT = schema.EDGE_TYPES


class HeteroState:
    """Numpy container for one graph snapshot (pre-padding)."""

    def __init__(self):
        self.features = {
            "grain": list(schema.GRAIN_FEATURES),
            "joint": list(schema.JOINT_FEATURES),
        }
        self.targets = {"grain": list(schema.GRAIN_TARGETS),
                        "joint": list(schema.JOINT_TARGETS)}
        self.targets_scaling = dict(schema.TARGET_SCALING)
        self.edge_type = list(schema.EDGE_TYPES)
        self.feature_dicts: Dict[str, np.ndarray] = {}
        self.target_dicts: Dict[str, np.ndarray] = {}
        self.edge_index_dicts: Dict[tuple, np.ndarray] = {}
        self.edge_weight_dicts: Dict[tuple, np.ndarray] = {}
        self.mask: Dict[str, np.ndarray] = {}
        self.physical_params: Dict = {}
        self.edges: List[list] = []          # jj COO incl. [-1,-1] slots
        self.vertex2joint: Dict[int, tuple] = {}
        self.span: int = 6


def tensorize(traj, frame: int) -> HeteroState:
    """Build the padded-free numpy state from a trajectory/planar snapshot.

    `traj` needs: num_regions, num_vertices, patch_size, mesh_size, frames,
    region_center, area_counts, vertices, joint2vertex, edges, theta_x/z,
    physical_params, BC, seed, (extraV_frames for frame>0).
    """
    hg = HeteroState()
    ng, nj = traj.num_regions, traj.num_vertices
    grain_state = np.zeros((ng, len(hg.features["grain"])))
    joint_state = np.zeros((nj, len(hg.features["joint"])))
    grain_mask = np.zeros((ng, 1), dtype=int)
    joint_mask = np.zeros((nj, 1), dtype=int)

    s = int(np.round(traj.patch_size / traj.mesh_size)) + 1

    for grain, coor in traj.region_center.items():
        grain_state[grain - 1, 0] = coor[0]
        grain_state[grain - 1, 1] = coor[1]
        grain_state[grain - 1, 3] = traj.area_counts.get(grain, 0) / s**2
        grain_mask[grain - 1, 0] = 1
    grain_state[:, 2] = frame / traj.frames
    if frame > 0 and hasattr(traj, "extraV_frames"):
        grain_state[:, 4] = traj.extraV_frames[:, frame] / s**3

    theta_x = traj.theta_x[1:]
    theta_z = traj.theta_z[1:]
    grain_state[:, 5] = np.cos(theta_x)
    grain_state[:, 6] = np.sin(theta_x)
    grain_state[:, 7] = np.cos(theta_z)
    grain_state[:, 8] = np.sin(theta_z)

    if traj.BC == "noflux":
        # boundary grain occupies slot 0 with neutral features
        grain_state[0, 0:2] = 0.5
        grain_state[0, 3:5] = 0
        grain_state[0, 5:9] = np.sqrt(2) / 2

    for joint, coor in traj.vertices.items():
        joint_state[joint, 0] = coor[0]
        joint_state[joint, 1] = coor[1]
        joint_mask[joint, 0] = 1
    joint_state[:, 2] = frame / traj.frames
    joint_state[:, 3] = 1 - traj.physical_params["G"] / 10
    joint_state[:, 4] = traj.physical_params["R"] / 2

    gj_edge, gj_len = [], []
    for grains, joint in traj.joint2vertex.items():
        for grain in grains:
            gj_edge.append([grain - 1, joint])
            gj_len.append(
                periodic_dist_pt(traj.vertices[joint], traj.region_center[grain])
            )
    jg_edge = [[j, g] for g, j in gj_edge]
    jj_edge = [[s_, d_] for s_, d_ in traj.edges if s_ > -1 and d_ > -1]
    jj_len = [
        periodic_dist_pt(traj.vertices[s_], traj.vertices[d_])
        if s_ > -1 and d_ > -1 else schema.EDGE_LEN_SENTINEL
        for s_, d_ in traj.edges
    ]

    hg.feature_dicts = {"grain": grain_state, "joint": joint_state}
    hg.edge_index_dicts = {
        PUSH: np.array(gj_edge).T,
        PULL: np.array(jg_edge).T,
        CONNECT: np.array(jj_edge).T,
    }
    hg.edge_weight_dicts = {
        PUSH: np.array(gj_len)[:, None],
        PULL: np.array(gj_len)[:, None],
        CONNECT: np.array(jj_len)[:, None],
    }
    hg.mask = {"grain": grain_mask, "joint": joint_mask}
    hg.edges = [list(e) for e in traj.edges]
    hg.vertex2joint = dict(traj.vertex2joint)
    hg.physical_params = dict(traj.physical_params)
    hg.physical_params.update({"seed": traj.seed, "height": frame})
    return hg


def form_gradient(
    hg: HeteroState,
    prev: Optional[HeteroState],
    nxt: Optional[HeteroState],
    event_list,
    elim_list,
    verbose: bool = False,
):
    """Targets + event labels from the next window and gradient features
    from the previous one. Mutates hg in place; must be called exactly once
    per state."""
    scale_g = hg.targets_scaling["grain"]
    scale_j = hg.targets_scaling["joint"]

    if nxt is not None:
        darea = nxt.feature_dicts["grain"][:, 3:4] - hg.feature_dicts["grain"][:, 3:4]
        hg.target_dicts["grain"] = scale_g * np.hstack(
            (darea, nxt.feature_dicts["grain"][:, 4:5])
        )
        hg.target_dicts["joint"] = scale_j * _subtract(
            nxt.feature_dicts["joint"][:, :2], hg.feature_dicts["joint"][:, :2], "next"
        )

        # invalidate joints whose grain neighborhood changed
        for i in range(len(hg.mask["joint"])):
            if hg.mask["joint"][i, 0] == 1:
                if i in nxt.vertex2joint and set(hg.vertex2joint[i]) == set(
                    nxt.vertex2joint[i]
                ):
                    pass
                else:
                    hg.mask["joint"][i, 0] = 0

        # edge-event labels on live jj edges
        hg.edges = [[s, d] for s, d in hg.edges if s > -1 and d > -1]
        labels = np.full(len(hg.edges), schema.EDGE_EVENT_INVALID, dtype=int)
        nxt_edges = [list(e) for e in nxt.edges]
        for i, pair in enumerate(hg.edges):
            if pair in nxt_edges:
                labels[i] = 1 if tuple(pair) in event_list else 0
        hg.target_dicts["edge_event"] = labels
        if verbose:
            print("number of positive/negative events",
                  int(np.sum(labels > 0)), int(np.sum(labels == 0)))

        # edge-length targets
        edge_pair = []
        for i, el in enumerate(hg.edge_weight_dicts[CONNECT][:, 0]):
            if el > -1:
                edge_pair.append([el, nxt.edge_weight_dicts[CONNECT][i, 0]])
        assert len(hg.edges) == len(edge_pair)
        hg.mask["edge"] = np.ones(len(hg.edges), dtype=int)
        hg.target_dicts["edge"] = np.zeros(len(hg.edges))
        for i, (el, el_n) in enumerate(edge_pair):
            if hg.target_dicts["edge_event"][i] > 0:
                hg.target_dicts["edge"][i] = 0.5 * scale_j * (-el_n - el)
            else:
                hg.target_dicts["edge"][i] = 0.5 * scale_j * (el_n - el)
            if hg.target_dicts["edge_event"][i] < 0 or el_n < -1:
                hg.mask["edge"][i] = 0

        # grain-event labels
        g_event = np.zeros(len(hg.mask["grain"]), dtype=int)
        for i in range(len(hg.mask["grain"])):
            if hg.mask["grain"][i] == 1 and nxt.mask["grain"][i] == 0:
                g_event[i] = 1
        hg.target_dicts["grain_event"] = g_event

        assert np.all(hg.mask["joint"] * hg.target_dicts["joint"] > -1) and np.all(
            hg.mask["joint"] * hg.target_dicts["joint"] < 1
        )
        assert np.all(hg.target_dicts["grain"] > -1) and np.all(
            hg.target_dicts["grain"] < 1
        )
        assert np.all(hg.mask["edge"] * hg.target_dicts["edge"] > -1) and np.all(
            hg.mask["edge"] * hg.target_dicts["edge"] < 1
        )

    # gradient (history) features
    if prev is None:
        hg.prev_grad_grain = 0 * hg.feature_dicts["grain"][:, :1]
        hg.prev_grad_joint = 0 * hg.feature_dicts["joint"][:, :2]
    else:
        hg.prev_grad_grain = scale_g * (
            hg.feature_dicts["grain"][:, 3:4] - prev.feature_dicts["grain"][:, 3:4]
        )
        hg.prev_grad_joint = scale_j * _subtract(
            hg.feature_dicts["joint"][:, :2], prev.feature_dicts["joint"][:, :2], "prev"
        )

    hg.feature_dicts["grain"][:, 4] *= scale_g
    hg.feature_dicts["grain"][:, schema.GRAIN_SPAN_COL] = hg.span / schema.SPAN_NORMALIZER
    hg.feature_dicts["joint"][:, schema.JOINT_SPAN_COL] = hg.span / schema.SPAN_NORMALIZER
    hg.feature_dicts["grain"] = np.hstack((hg.feature_dicts["grain"], hg.prev_grad_grain))
    hg.feature_dicts["joint"] = np.hstack((hg.feature_dicts["joint"], hg.prev_grad_joint))
    hg.features["grain"] = hg.features["grain"] + list(schema.GRAIN_GRAD_FEATURES)
    hg.features["joint"] = hg.features["joint"] + list(schema.JOINT_GRAD_FEATURES)


def _subtract(b, a, loc):
    n = len(a)
    if loc == "prev":
        return np.concatenate((b[:n, :] - a, 0 * b[n:, :]), axis=0)
    return b[:n, :] - a


def _fillup(b, a):
    n = len(a)
    return np.concatenate((a, 0 * b[n:, :]), axis=0)


def append_history(hg: HeteroState, prev_list):
    """Append up to `window-1` earlier gradient columns, and compact the
    deleted jj edge-weight rows."""
    exist = np.where(hg.edge_weight_dicts[CONNECT][:, 0] > -1)[0]
    hg.edge_weight_dicts[CONNECT] = hg.edge_weight_dicts[CONNECT][exist, :]
    for prev in prev_list:
        if prev is None:
            g = 0 * hg.feature_dicts["grain"][:, :1]
            j = 0 * hg.feature_dicts["joint"][:, :2]
        else:
            g = _fillup(hg.prev_grad_grain, prev.prev_grad_grain)
            j = _fillup(hg.prev_grad_joint, prev.prev_grad_joint)
        hg.feature_dicts["grain"] = np.hstack((hg.feature_dicts["grain"], g))
        hg.feature_dicts["joint"] = np.hstack((hg.feature_dicts["joint"], j))
    return hg
