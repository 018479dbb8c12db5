"""The one generator of every traffic mix: a traffic file (traffic/<name>.json)
gives the lanes of a build, their domain and process parameters and the
rollout's settings; the seed gives each lane its starting microstructure.

A build is `spans` static spans of the batched rollout from the stacked
starting state of `lanes` independent lanes. Lane i starts from the
benchmark's own periodic Voronoi microstructure of seed + i (lane_graph):
the published recipe's seed lattice (hexagonal, mean spacing
`grain_spacing` um, gaussian jitter), exact Voronoi junctions, and the
t = 0 features of the port's generate mode, which the port's
init_scaled_state turns into its device state. Every lane's graph keeps
to the graph schema by construction: three grains and three junctions at
every junction, every jj edge listed both ways. The traffic is a closed
loop: builds run back to back, each from the same starting state.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np

PATCH_UM = 40.0           # the training patch the models were fitted on
MESH_UM = 0.08            # the phase-field mesh, pixels of the area feature
SPAN_NORMALIZER = 120.0   # the span feature's scale
NOISE = 0.01              # the seed lattice's jitter variance at 40 um
CENTER_TILE = 4           # the unit cell among the 3 x 3 tiles
MARGIN = 4.0              # the band of images around it, in spacings


def lane_seeds(traffic: Dict, seed: int) -> List[int]:
    return [seed + i for i in range(traffic["lanes"])]


def seed_points(rng, lxd: float, spacing: float) -> np.ndarray:
    """The grains' seeds in the unit cell: a hexagonal lattice of nearest
    distance spacing / lxd, shifted and jittered as the published
    generator's (variance NOISE / lxd / (lxd / PATCH_UM))."""
    dx = spacing / lxd
    rows, cols = int(1 / dx) + 1, int(1 / dx)
    r, c = np.meshgrid(np.arange(2 * rows), np.arange(cols), indexing="ij")
    x = (c + 0.5 * (r % 2)) * math.sqrt(3) * dx + 0.1 * dx
    y = r * 0.5 * dx + 0.25 * dx
    pts = np.stack([x.ravel(), y.ravel()], 1)
    sd = math.sqrt(NOISE / lxd / (lxd / PATCH_UM))
    pts = pts + rng.normal(0.0, sd, pts.shape)
    keep = (pts >= 0).all(1) & (pts < 1).all(1)
    return pts[keep]


def _circumcenters(p: np.ndarray) -> np.ndarray:
    """[m, 2] circumcenters of triangles p [m, 3, 2]."""
    a, b, c = p[:, 0], p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
    d = 2 * (b[:, 0] * c[:, 1] - b[:, 1] * c[:, 0])
    bb, cc = (b * b).sum(1), (c * c).sum(1)
    ux = (c[:, 1] * bb - b[:, 1] * cc) / d
    uy = (b[:, 0] * cc - c[:, 0] * bb) / d
    return a + np.stack([ux, uy], 1)


def lane_graph(traffic: Dict, seed: int) -> Tuple:
    """The starting graph of one lane as host arrays, in the form the port's
    init_scaled_state takes: (x, edges, mask, lxd, patch_size), float64
    features [grain: x y z area extraV cosx sinx cosz sinz span darea;
    joint: x y z G R span dx dy], pull [2, 3 NJ] joint -> grain, connect
    [2, 3 NJ] jj, every edge both ways."""
    from scipy.spatial import Delaunay

    lxd = float(traffic["lxd"])
    rng = np.random.default_rng(seed)
    pts = seed_points(rng, lxd, float(traffic["grain_spacing"]))
    n = len(pts)
    off = np.array([(i, j) for i in (-1, 0, 1) for j in (-1, 0, 1)], float)
    tiled = (pts[None] + off[:, None]).reshape(-1, 2)
    # the unit cell and a band of its images MARGIN spacings wide
    m = MARGIN * float(traffic["grain_spacing"]) / lxd
    kept = np.nonzero(((tiled > -m) & (tiled < 1 + m)).all(1))[0]
    tiled = tiled[kept]
    tri = Delaunay(tiled).simplices
    tri = tri[(kept[tri] // n == CENTER_TILE).any(1)]
    tile, grain = kept[tri] // n, kept[tri] % n
    cc = _circumcenters(tiled[tri])

    # a junction is a periodic class of triangles: its grains, sorted, and
    # the tiles of the second and third relative to the first's
    order = np.argsort(grain, 1, kind="stable")
    g_s = np.take_along_axis(grain, order, 1)
    o_s = off[np.take_along_axis(tile, order, 1)]
    rel = (o_s[:, 1:] - o_s[:, :1]).reshape(-1, 4).astype(np.int64) + 2
    key = (g_s[:, 0] * n + g_s[:, 1]) * n + g_s[:, 2]
    for k in range(4):                     # each relative offset in -2..2
        key = key * 5 + rel[:, k]
    _, first, junction = np.unique(key, return_index=True,
                                   return_inverse=True)
    junction = junction.reshape(-1)
    nj = len(first)
    if (g_s[:, 0] == g_s[:, 1]).any() or (g_s[:, 1] == g_s[:, 2]).any():
        raise ValueError(f"lxd {lxd}: a grain meets its own image")
    pos_j = cc[first] % 1.0

    # each grain's ring: the triangles at its centre-tile seed, by angle
    at, col = np.nonzero(tile == CENTER_TILE)
    g = grain[at, col]
    d = cc[at] - tiled[tri[at, col]]
    ring_order = np.lexsort((np.arctan2(d[:, 1], d[:, 0]), g))
    at, g = at[ring_order], g[ring_order]
    ring_j, ring_p = junction[at], cc[at]
    starts = np.searchsorted(g, np.arange(n))
    nxt = np.arange(len(g)) + 1
    ends = np.append(starts[1:], len(g))
    nxt[ends - 1] = starts
    area = 0.5 * np.bincount(
        g, ring_p[:, 0] * ring_p[nxt, 1] - ring_p[nxt, 0] * ring_p[:, 1], n)
    center = np.stack([np.bincount(g, ring_p[:, k], n) for k in (0, 1)], 1)
    center = (center / np.bincount(g, minlength=n)[:, None]) % 1.0
    connect = np.stack([ring_j, ring_j[nxt]]).astype(np.int64)

    pull = np.stack([np.repeat(np.arange(nj), 3), g_s[first].reshape(-1)])

    image = int(lxd / MESH_UM) + 1            # pixels of the domain's side
    patch = int(round(PATCH_UM / MESH_UM)) + 1
    span = float(traffic["span"])
    u = rng.standard_normal((3, n))
    theta_x = np.arctan2(u[1], u[0]) % (math.pi / 2)
    theta_z = np.arctan2(np.hypot(u[0], u[1]), u[2]) % (math.pi / 2)
    xg = np.zeros((n, 11))
    xg[:, :2] = center
    xg[:, 3] = area * image ** 2 / patch ** 2
    xg[:, 5], xg[:, 6] = np.cos(theta_x), np.sin(theta_x)
    xg[:, 7], xg[:, 8] = np.cos(theta_z), np.sin(theta_z)
    xg[:, 9] = span / SPAN_NORMALIZER
    xj = np.zeros((nj, 8))
    xj[:, :2] = pos_j
    xj[:, 3] = 1 - traffic["G"] / 10
    xj[:, 4] = traffic["R"] / 2
    xj[:, 5] = span / SPAN_NORMALIZER
    return ({"grain": xg, "joint": xj},
            {"pull": pull.astype(np.int32), "connect": connect.astype(np.int32)},
            {"grain": np.ones(n, np.int32), "joint": np.ones(nj, np.int32)},
            lxd, PATCH_UM)


def lane_graphs(traffic: Dict, seed: int) -> List[Tuple]:
    """Every lane's starting graph, lane i from seed + i."""
    return [lane_graph(traffic, s) for s in lane_seeds(traffic, seed)]


def starting_state(graphs: List[Tuple], device):
    """The stacked starting state of a build on `device` and the lanes'
    single states (the port's DeviceRolloutState objects), from the lanes'
    host graphs."""
    from graingraphnn_torch.rollout import device_driver as dd
    from graingraphnn_torch.rollout import device_rollout as dr

    singles = [dd.init_scaled_state(x, edges, mask, lxd, patch,
                                    device=device)[0]
               for x, edges, mask, lxd, patch in graphs]
    return dr.stack_states(singles), singles
