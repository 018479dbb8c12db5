"""Driver of the device-resident rollout: the patch-rescaled starting state.

For domains larger than the 40 um training patch, local geometry is scaled
to the training distribution, with per-joint offsets kept for
reconstruction in global coordinates. The run with QoIs waits for the QoI
and planar-reconstruction modules of a later slice.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from . import device_rollout as dr

FIXTURE_120 = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "gen120_seed5.npz")


def load_fixture(path: str = FIXTURE_120):
    """The committed starting graph: (x, edges, mask, lxd, patch_size),
    the host arrays init_scaled_state takes. FIXTURE_120 is the 120 um
    generate-mode Voronoi graph, seed 5, G=1.904, R=0.558 (~1043 grains,
    2086 junctions)."""
    with np.load(path) as z:
        x = {"grain": z["x_grain"], "joint": z["x_joint"]}
        edges = {"pull": z["edges_pull"], "connect": z["edges_connect"]}
        mask = {"grain": z["mask_grain"],
                "joint": np.ones(len(z["x_joint"]), np.int32)}
        return x, edges, mask, float(z["lxd"]), float(z["patch_size"])


def init_scaled_state(x: Dict[str, np.ndarray], edges: Dict[str, np.ndarray],
                      mask: Dict[str, np.ndarray], lxd: float,
                      patch_size: float, *, pp_cap=None,
                      nucleation_slack: int = 0, device="cuda"):
    """Patch-rescaled device state from host arrays (float64 features,
    E_pq/E_pp COO, masks). Returns (state, offset_j, domain_factor)."""
    x = {k: np.array(v, dtype=np.float64) for k, v in x.items()}
    connect = np.asarray(edges["connect"], np.int64)
    edges = {"pull": np.asarray(edges["pull"], np.int64),
             "connect": connect[:, connect[0] > -1]}
    domain_factor = lxd / patch_size
    offset_j = np.zeros((len(x["joint"]), 2))
    if domain_factor > 1:
        x["grain"][:, :2] *= domain_factor
        x["joint"][:, :2] *= domain_factor
        offset_j = np.floor(x["joint"][:, :2])
        x["joint"][:, :2] -= offset_j
        x["grain"][:, :2] -= x["grain"][:, :2] - x["grain"][:, :2] % 1
    st = dr.init_device_state(
        {k: v.astype(np.float32) for k, v in x.items()}, edges, mask,
        pp_cap=pp_cap, nucleation_slack=nucleation_slack, device=device)
    return st, offset_j, domain_factor
