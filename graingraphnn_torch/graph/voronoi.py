"""Seeded initial microstructure (host side, numpy and scipy).

A seeded hexagonal (periodic) or uniform-random (no-flux) point lattice
with mirrored ghost points, scipy's Voronoi diagram, vertex dedup and
wrap, degree-4 "quadruple" splitting, per-grain orientation sampling and
the polygon raster (graph.planar).

All draws come from one `numpy.random.RandomState(seed)`, taken in the
JAX package's order (lattice noise, orientations, then the truncated
normal's draws through `random_state=`): the same MT19937 stream as its
global `np.random.seed(seed)`, so the same seed gives the same graph,
and no global state is touched.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Optional

import numpy as np
from scipy.spatial import Voronoi
from scipy.stats import truncnorm

from .planar import EPS, PlanarGraph


def _in_bound(x, y, max_y=1.0, cone_ratio=0.0):
    return (
        x >= -EPS
        and x <= 1 + EPS
        and y >= -EPS + cone_ratio * (1 - x)
        and y <= max_y - cone_ratio * (1 - x) + EPS
    )


def hexagonal_lattice(rng, dx, noise, bc="periodic", max_y=1.0,
                      cone_ratio=0.0):
    """Hexagonal seed lattice with gaussian jitter and mirrored ghost
    points; the jitter is drawn from rng (a RandomState)."""
    rows, cols = int(1 / dx) + 1, int(1 / dx)
    shiftx, shifty = 0.1 * dx, 0.25 * dx
    rand_noise = rng.multivariate_normal(
        mean=np.zeros(2), cov=np.eye(2) * noise, size=rows * cols * 5
    )
    points, in_points = [], []
    count = 0
    for row in range(rows * 2):
        for col in range(cols):
            count += 1
            x = (col + 0.5 * (row % 2)) * math.sqrt(3) * dx + shiftx
            y = row * 0.5 * dx + shifty
            x += rand_noise[count, 0]
            y += rand_noise[count, 1]
            if _in_bound(x, y, max_y, cone_ratio):
                in_points.append([x, y])
                points.append([x, y])
                if bc == "noflux":
                    points.append([-x, y])
                    points.append([2 - x, y])
                    points.append([
                        -(2 * cone_ratio * y + (cone_ratio**2 - 1) * x - 2 * cone_ratio**2) / (1 + cone_ratio**2),
                        -((1 - cone_ratio**2) * y + 2 * cone_ratio * x - 2 * cone_ratio) / (1 + cone_ratio**2),
                    ])
                    points.append([
                        -(-2 * cone_ratio * y + (cone_ratio**2 - 1) * x + 2 * cone_ratio * (max_y - cone_ratio)) / (1 + cone_ratio**2),
                        -((1 - cone_ratio**2) * y - 2 * cone_ratio * x - 2 * cone_ratio * (max_y - cone_ratio)) / (1 + cone_ratio**2),
                    ])
                elif bc == "periodic":
                    points.extend([
                        [x + 1, y], [x - 1, y], [x, y + 1], [x, y - 1],
                        [x + 1, y + 1], [x - 1, y - 1], [x - 1, y + 1], [x + 1, y - 1],
                    ])
    return points, in_points


def random_lattice(rng, dx, noise, bc="periodic", max_y=1.0,
                   cone_ratio=0.0):
    """Uniform-random seed lattice drawn from rng (a RandomState).

    The y of the last no-flux ghost point subtracts 2 * (max_y -
    cone_ratio), where hexagonal_lattice subtracts 2 * cone_ratio *
    (max_y - cone_ratio); kept as the JAX package has it."""
    rows, cols = int(1 / dx), int(1 / dx)
    rand = rng.rand(rows * cols, 2)
    points, in_points = [], []
    for count in range(rows * cols):
        x, y = rand[count, 0], rand[count, 1]
        if _in_bound(x, y, max_y, cone_ratio):
            in_points.append([x, y])
            points.append([x, y])
            if bc == "noflux":
                points.append([-x, y])
                points.append([2 - x, y])
                points.append([
                    -(2 * cone_ratio * y + (cone_ratio**2 - 1) * x - 2 * cone_ratio**2) / (1 + cone_ratio**2),
                    -((1 - cone_ratio**2) * y + 2 * cone_ratio * x - 2 * cone_ratio) / (1 + cone_ratio**2),
                ])
                points.append([
                    -(-2 * cone_ratio * y + (cone_ratio**2 - 1) * x + 2 * cone_ratio * (max_y - cone_ratio)) / (1 + cone_ratio**2),
                    -((1 - cone_ratio**2) * y - 2 * cone_ratio * x - 2 * (max_y - cone_ratio)) / (1 + cone_ratio**2),
                ])
            elif bc == "periodic":
                points.extend([
                    [x + 1, y], [x - 1, y], [x, y + 1], [x, y - 1],
                    [x + 1, y + 1], [x - 1, y - 1], [x - 1, y + 1], [x + 1, y - 1],
                ])
    return points, in_points


class Microstructure(PlanarGraph):
    """Seeded initial 2D microstructure and per-grain orientations, from
    (lxd, seed, noise, bc) or a user_defined_config dict (boundary,
    geometry, initial_parameters)."""

    def __init__(
        self,
        lxd: float = 40,
        seed: int = 1,
        noise: float = 0.01,
        bc: str = "periodic",
        rand_init: bool = True,
        adjust_grain_size: bool = False,
        adjust_grain_orien: bool = False,
        user_defined_config: Optional[dict] = None,
    ):
        if user_defined_config:
            cfg = user_defined_config
            bc = cfg["boundary"]
            lxd = cfg["geometry"]["lxd"]
            self.lyd = lxd * cfg["geometry"]["yx_asp_ratio"]
            self.lzd = lxd * cfg["geometry"]["zx_asp_ratio"]
            self.ini_height = cfg["geometry"]["z0"]
            self.final_height = self.ini_height + self.lzd
            self.cone_ratio = cfg["geometry"]["cone_ratio"]
            self.mesh_size = cfg["initial_parameters"]["mesh_size"]
            self.ini_grain_size = cfg["initial_parameters"]["grain_size_mean"]
            seed = cfg["initial_parameters"]["seed"]
            noise = cfg["initial_parameters"]["noise_level"]
        else:
            self.lyd = lxd
            self.ini_height, self.final_height = 2, 50
            self.cone_ratio = 0
            self.mesh_size = 0.08
            self.ini_grain_size = 4

        if adjust_grain_size:
            self.ini_grain_size = 2 + (seed % 10) / 5 * 3

        self.lxd = lxd
        self.seed = seed
        self.patch_size = 40
        self.patch_grid_size = int(round(self.patch_size / self.mesh_size))
        imagesize = (int(lxd / self.mesh_size) + 1, int(self.lyd / self.mesh_size) + 1)
        super().__init__(bc=bc, imagesize=imagesize)
        self.max_y = self.lyd / self.lxd

        self.density = self.ini_grain_size / self.lxd
        self.noise = noise / self.lxd / (self.lxd / self.patch_size)

        if not rand_init:
            return

        rng = np.random.RandomState(seed)
        if bc == "periodic":
            self._voronoi_periodic(rng)
        elif bc == "noflux":
            self._voronoi_noflux(rng)
        else:
            raise KeyError(bc)
        self.joint2vertex = {tuple(sorted(v)): k for k, v in self.vertex2joint.items()}
        self.rebuild_regions(init_edges=True)
        self.rasterize()
        self.alpha_pde = self.alpha_field.copy()

        self.num_regions = len(self.regions)
        self.num_vertices = len(self.vertices)
        self.num_edges = len(self.edges)
        ids, counts = np.unique(self.alpha_field, return_counts=True)
        self.area_counts = dict(zip(ids, counts))

        # orientations
        ux = rng.randn(self.num_regions)
        uy = rng.randn(self.num_regions)
        uz = rng.randn(self.num_regions)
        self.theta_x = np.zeros(1 + self.num_regions)
        self.theta_z = np.zeros(1 + self.num_regions)
        self.theta_x[1:] = np.arctan2(uy, ux) % (math.pi / 2)
        if adjust_grain_orien:
            low, up = 0, math.pi / 2
            mean, sd = 0 + math.pi / 36 * (seed % 10), 0.4
            gen = truncnorm((low - mean) / sd, (up - mean) / sd, loc=mean, scale=sd)
            self.theta_z[1:] = gen.rvs(self.num_regions, random_state=rng)
        else:
            self.theta_z[1:] = np.arctan2(np.sqrt(ux**2 + uy**2), uz) % (math.pi / 2)

        area = np.array(list(self.area_counts.values())) * self.mesh_size**2
        self.ini_grain_dis = np.sqrt(4 * area / math.pi)

    # ------------------------------------------------------------------
    def _voronoi_periodic(self, rng):
        """Periodic Voronoi graph: dedup wrapped vertices, unique regions,
        split degree-4 quadruple vertices into two degree-3 twins."""
        mirrored, _ = hexagonal_lattice(rng, dx=self.density,
                                        noise=self.noise, bc=self.BC)
        vor = Voronoi(mirrored)
        # wrapped vertices, rounded to 4 decimals as np.float64 scalars
        # (numpy's rounding, as round() of a numpy scalar gives)
        wrapped = np.round(vor.vertices % 1, 4)

        seen_regions, seen = [], set()   # in order, and for lookups
        vert_map = {}
        vert_count = 0
        alpha = 0

        v2j = defaultdict(set)
        for region in vor.regions:
            ok = bool(region)
            for idx in region:
                if idx == -1:
                    ok = False
                    break
                x, y = vor.vertices[idx]
                if x <= -0.5 - EPS or y <= -0.5 - EPS or x >= 1.5 + EPS or y >= 1.5 + EPS:
                    ok = False
                    break
            if not ok:
                continue
            ring = []
            for idx in region:
                pt = (wrapped[idx, 0], wrapped[idx, 1])
                if pt not in vert_map:
                    self.vertices[vert_count] = pt
                    vert_map[pt] = vert_count
                    ring.append(vert_count)
                    vert_count += 1
                else:
                    ring.append(vert_map[pt])
            key = tuple(sorted(ring))
            if key in seen:
                continue
            seen_regions.append(key)
            seen.add(key)
            alpha += 1
            for v in ring:
                v2j[v].add(alpha)

        # split quadruples
        self.quadruples = {}
        for k, grains in list(v2j.items()):
            if len(grains) > 3:
                glist = list(grains)
                twin = len(v2j)
                first = glist[0]
                grains.remove(first)
                v2j[twin] = set(grains)
                grains.add(first)
                self.vertices[twin] = self.vertices[k]

                n1 = seen_regions[first - 1]
                remove_grain = None
                for g in glist[1:]:
                    if len(set(n1) & set(seen_regions[g - 1])) == 1:
                        remove_grain = g
                        break
                grains.remove(remove_grain)
                v2j[k] = set(grains)
                grains.remove(first)
                rest = list(grains)
                self.quadruples.update({rest[0]: (k, twin), rest[1]: (k, twin)})

        self.vertex2joint = dict(v2j)

    def _voronoi_noflux(self, rng):
        """No-flux Voronoi graph: boundary grain id 1 absorbs the
        degree-deficient boundary vertices; corner grains are recorded for
        the raster's fill."""
        mirrored, _ = random_lattice(
            rng, dx=self.density, noise=self.noise, bc=self.BC,
            max_y=self.max_y, cone_ratio=self.cone_ratio,
        )
        vor = Voronoi(mirrored)
        cone_ratio, max_y = self.cone_ratio, self.max_y

        v2j = defaultdict(set)
        vert_map = {}
        vert_count = 0
        alpha = 1
        for region in vor.regions:
            ok = bool(region)
            indomain = 0
            for idx in region:
                if idx == -1:
                    ok = False
                    break
                x, y = vor.vertices[idx]
                if (x <= -EPS or y <= cone_ratio * (1 - x) - EPS
                        or x >= 1.0 + EPS or y >= max_y - cone_ratio * (1 - x) + EPS):
                    ok = False
                    break
                if (EPS < x < 1 - EPS and EPS + cone_ratio * (1 - x) < y < max_y - cone_ratio * (1 - x) - EPS):
                    indomain += 1
            if not (ok and indomain > 0):
                continue
            ring = []
            for idx in region:
                x, y = vor.vertices[idx]
                if (abs(x) < EPS or abs(1 - x) < EPS) and (
                    abs(y - cone_ratio) < EPS or abs(max_y - cone_ratio - y) < EPS
                ):
                    if abs(x) < EPS and abs(y - cone_ratio) < EPS:
                        self.corner_grains[0] = alpha + 1
                    if abs(1 - x) < EPS and abs(y) < EPS:
                        self.corner_grains[1] = alpha + 1
                    if abs(x) < EPS and abs(max_y - cone_ratio - y) < EPS:
                        self.corner_grains[2] = alpha + 1
                    if abs(1 - x) < EPS and abs(max_y - y) < EPS:
                        self.corner_grains[3] = alpha + 1
                    continue
                pt = (x, y)
                if pt not in vert_map:
                    self.vertices[vert_count] = pt
                    vert_map[pt] = vert_count
                    ring.append(vert_count)
                    vert_count += 1
                else:
                    ring.append(vert_map[pt])
            alpha += 1
            for v in ring:
                v2j[v].add(alpha)

        for k, v in list(v2j.items()):
            if len(v) < 3:
                v2j[k].add(1)
        for k, v in list(v2j.items()):
            if len(v) < 3:
                del v2j[k]
        self.vertex2joint = dict(v2j)
