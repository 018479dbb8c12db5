"""Graph trajectories and their samples: phase-field extraction and
generate mode.

`TrajectoryExtractor` owns the seeded starting graph (graph.voronoi) of
one trajectory with its thermal parameters, its per-frame states and the
event lists between frames. In phase-field (PF) mode it reads a PF
simulation (`load_pf_file`: an .h5 or .h5.gz file; `load_pf_arrays`: the
same seven arrays in memory) and `extract_frames` follows it frame by
frame:

* junctions of each frame from the PF `node_region` candidates, repaired
  with the 4-grain ("quadruple") candidates where the connectivity count
  is short (`check_connectivity`, `repair_with_quadruples`),
* the difference to the previous frame classified into E0 (motion), E1
  (neighbour switching, matched through the quadruple keys of vanished
  and new junction triples) and E2 (grain elimination, merged groups
  included),
* frames whose junctions cannot be matched quarantined
  (save_frame=False) rather than failing.

`generate` builds a trajectory in generate mode (no PF data). All of it
is host-side numpy and Python containers, float64, with the JAX package's
containers and loop order: the repairs stop at their first success, so
the insertion order of the dicts decides the graph. `make_test_sample` is
the t=0 inference input, `make_training_samples` the windowed training
pairs of a trajectory whose states and events are filled, with
`calibrate_span` choosing the window.
"""

from __future__ import annotations

import glob
import gzip
import itertools
import math
import os
import re
import shutil
from typing import Dict, List, Set, Tuple

import numpy as np

from ..graph.planar import periodic_move_pt, shares_two_grains
from ..graph.voronoi import Microstructure
from . import heterograph

PF_KEYS = ("x_coordinates", "y_coordinates", "z_coordinates", "cross_sec",
           "extra_area", "total_area", "node_region")


# ---------------------------------------------------------------------------
# connectivity repair
# ---------------------------------------------------------------------------


def check_connectivity(cur_joint: Dict[tuple, list]):
    """Each junction key should share exactly two grains with exactly three
    other keys. Returns (total missing links, candidate grains, per-key
    deficit in key order)."""
    candidates: Set[int] = set()
    miss_case: Dict[tuple, int] = {}
    total_missing = 0
    keys = list(cur_joint.keys())
    sets = [set(k) for k in keys]
    # keys sharing two grains share a grain pair: count only those
    by_pair: Dict[tuple, List[int]] = {}
    for i, s in enumerate(sets):
        for pair in itertools.combinations(sorted(s), 2):
            by_pair.setdefault(pair, []).append(i)
    for i, k1 in enumerate(keys):
        near = set()
        for pair in itertools.combinations(sorted(sets[i]), 2):
            near.update(by_pair[pair])
        num_link = sum(1 for j in near
                       if keys[j] != k1 and len(sets[i] & sets[j]) == 2)
        if num_link != 3:
            candidates.update(sets[i])
            miss_case[k1] = 3 - num_link
            total_missing += abs(3 - num_link)
    return total_missing, candidates, miss_case


def repair_with_quadruples(quadruples, total_missing, cur_joint, miss_case,
                           del_joints):
    """Insert junction triples drawn from the quadruple candidates, one or
    two at a time, and keep the first insertion that lowers the
    connectivity deficit by what the quadruple's neighbourhood lacks."""
    for q, coor in quadruples.items():
        possible = list(itertools.combinations(list(q), 3))
        for c in miss_case.keys():
            if c in possible:
                possible.remove(c)
        miss_sum = 0
        for key, deficit in miss_case.items():
            if len(set(key) & set(q)) >= 2:
                miss_sum += deficit
        if miss_sum == 0:
            continue
        max_case = 1 if miss_sum < 4 else 2
        for ans in itertools.combinations(possible, max_case):
            for a in ans:
                cur_joint[a] = del_joints[a] if a in del_joints else coor
            cur, _, case_new = check_connectivity(cur_joint)
            if (miss_sum > 0 and cur == total_missing - miss_sum
                    and len(case_new) <= len(miss_case)):
                total_missing = cur
                break
            for a in ans:
                del cur_joint[a]


def _quadruple_keys(junctions):
    """The 4-grain key of each pair of junction triples that differ in
    exactly one grain, with the pair."""
    quadruples = {}
    pairs = set()
    for i in junctions:
        for j in junctions:
            if len(set(i) - set(j)) == 1:
                if (j, i) not in pairs:
                    pairs.add((i, j))
                    quadruples[tuple(sorted(set(i) | set(j)))] = (i, j)
    return quadruples


def _relative_angle(p1, p2):
    p1 = periodic_move_pt(list(p1), p2)
    return math.atan2(p2[1] - p1[1], p2[0] - p1[0])


def maybe_gunzip(path: str, cache_dir: str) -> str:
    """path itself, or for a .gz file its unpacked copy in cache_dir
    (unpacked once)."""
    if not path.endswith(".gz"):
        return path
    os.makedirs(cache_dir, exist_ok=True)
    out = os.path.join(cache_dir, os.path.basename(path)[:-3])
    if not os.path.exists(out):
        with gzip.open(path, "rb") as f_in, open(out, "wb") as f_out:
            shutil.copyfileobj(f_in, f_out)
    return out


def find_pf_file(rawdat_dir: str, seed: int) -> List[str]:
    """The PF files of `seed` in rawdat_dir (*seed<seed>_*.h5[.gz]),
    sorted."""
    return sorted(glob.glob(rawdat_dir + "/*seed" + str(seed) + "_*.h5")
                  + glob.glob(rawdat_dir + "/*seed" + str(seed) + "_*.h5.gz"))


class TrajectoryExtractor(Microstructure):
    """The per-frame graph states of one trajectory and the event lists
    between frames."""

    def __init__(
        self,
        lxd: float = 40,
        seed: int = 1,
        frames: int = 121,
        noise: float = 0.01,
        bc: str = "periodic",
        adjust_grain_size: bool = False,
        adjust_grain_orien: bool = False,
        physical_params: dict | None = None,
        user_defined_config: dict | None = None,
        rand_init: bool = True,
        verbose: bool = False,
    ):
        super().__init__(
            lxd=lxd, seed=seed, noise=noise, bc=bc, rand_init=rand_init,
            adjust_grain_size=adjust_grain_size,
            adjust_grain_orien=adjust_grain_orien,
            user_defined_config=user_defined_config,
        )
        if user_defined_config:
            self.physical_params = user_defined_config["physical_parameters"]
        else:
            self.physical_params = dict(physical_params or {})
        self.joint2vertex = {tuple(sorted(v)): k
                             for k, v in self.vertex2joint.items()}
        self.frames = frames
        self.train_test_frame_ratio = 120 // (frames - 1)
        self.load_frames = frames
        self.match_graph = True
        self.verbose = verbose

        self.edge_events: List[set] = []
        self.grain_events: List[set] = []
        self.states: List[heterograph.HeteroState] = []
        self.save_frame = [True] * frames
        self.area_traj: List[dict] = []
        self.extraV_traj: List = []

    def _log(self, *a):
        if self.verbose:
            print(*a)

    # ------------------------------------------------------------------
    # the PF data
    # ------------------------------------------------------------------
    def load_pf_file(self, rawdat_dir: str, cache_dir: str = "./data_cache"):
        """Read the PF file of this seed in rawdat_dir (the first of
        find_pf_file; a .gz is unpacked into cache_dir). G, Rmax and the
        frame count come from the file name (..._G<G>_Rmax<R>_..._frames<N>
        ..., N + 1 frames)."""
        import h5py

        path = maybe_gunzip(find_pf_file(rawdat_dir, self.seed)[0], cache_dir)
        self.data_file = path
        with h5py.File(path, "r") as f:
            arrays = {k: np.asarray(f[k]) for k in PF_KEYS}
        g = re.search(r"G(\d+\.\d+)", path).group(1)
        r = re.search(r"Rmax(\d+\.\d+)", path).group(1)
        data_frames = int(re.search(r"frames(\d+)", path).group(1)) + 1
        self.load_pf_arrays(arrays, float(g), float(r), data_frames)

    def load_pf_arrays(self, arrays: Dict[str, np.ndarray], G: float,
                       R: float, data_frames: int):
        """Take a PF simulation's arrays (PF_KEYS, as an .h5 file holds
        them): x/y/z coordinates in um with a ghost point at each end,
        cross_sec the grain id of each pixel and frame (fnx * fny * frames,
        Fortran order, a ghost border around each frame), extra_area and
        total_area (num_regions * frames, Fortran order) and node_region
        (8 * nodes * frames, Fortran order: the x and y indices of a
        junction candidate, its max_nb, then up to 5 grain labels padded
        with -1)."""
        self.x = np.asarray(arrays["x_coordinates"])
        self.y = np.asarray(arrays["y_coordinates"])
        self.z = np.asarray(arrays["z_coordinates"])
        alpha = np.asarray(arrays["cross_sec"])
        extra = np.asarray(arrays["extra_area"])
        total = np.asarray(arrays["total_area"])
        node_region = np.asarray(arrays["node_region"])

        if int(self.lxd) != int(self.x[-2]):
            raise ValueError(f"PF domain {self.x[-2]} um, extractor "
                             f"{self.lxd} um")
        self.x = self.x / self.lxd
        self.y = self.y / self.lxd
        self.z = self.z / self.lxd
        fnx, fny = len(self.x), len(self.y)
        if (fnx - 2, fny - 2) != tuple(self.imagesize):
            raise ValueError(f"PF raster {(fnx - 2, fny - 2)}, extractor "
                             f"{tuple(self.imagesize)}")
        self.physical_params = {"G": float(G), "R": float(R)}

        self.alpha_pde_frames = alpha.reshape((fnx, fny, data_frames),
                                              order="F")[1:-1, 1:-1, :]
        self.extraV_frames = extra.reshape((self.num_regions, data_frames),
                                           order="F")
        self.totalV_frames = total.reshape((self.num_regions, data_frames),
                                           order="F")

        nvf = 8  # x, y, max-neighbor, then 5 candidate grain labels
        self.num_vertex_features = nvf
        nodes = len(node_region) // (nvf * data_frames)
        nr = node_region.reshape((nvf, nodes, data_frames), order="F")
        self.active_coors = nr[:2]
        self.active_max = nr[2]
        self.active_args = nr[3:]

    # ------------------------------------------------------------------
    # the junctions of one frame
    # ------------------------------------------------------------------
    def _detect_junctions(self, frame: int, prev_joint, cur_grain):
        cur_joint: Dict[tuple, list] = {}
        quadruples: Dict[tuple, list] = {}
        for vtx in range(self.active_args.shape[1]):
            max_nb = self.active_max[vtx, frame]
            args = set(self.active_args[:, vtx, frame])
            xp = self.x[self.active_coors[0, vtx, frame]]
            yp = self.y[self.active_coors[1, vtx, frame]]
            args.discard(-1)
            if not args:
                continue
            key = tuple(sorted(args))
            if len(key) == 4:
                if key not in quadruples or max_nb < quadruples[key][2]:
                    quadruples[key] = [xp, yp, max_nb]
                continue
            if len(key) > 4:
                self._log("found junction candidate with >4 grains", key)
                continue
            if key not in cur_joint or max_nb < cur_joint[key][2]:
                cur_joint[key] = [xp, yp, max_nb]

        if self.BC == "noflux":
            self._boundary_junctions(self.alpha_pde.T, cur_joint)

        # quarantine junctions that are quadruple fragments unseen before
        del_joints = {}
        for q in quadruples:
            ql = list(q)
            for comb in ([0, 1, 2], [0, 1, 3], [0, 2, 3], [1, 2, 3]):
                arg = tuple(ql[i] for i in comb)
                if arg not in prev_joint and arg in cur_joint:
                    del_joints[arg] = cur_joint[arg]
                    del cur_joint[arg]

        total_missing, _, miss_case = check_connectivity(cur_joint)
        repair_with_quadruples(quadruples, total_missing, cur_joint,
                               miss_case, del_joints)
        total_missing, _, miss_case = check_connectivity(cur_joint)

        if self.BC == "periodic" and len(cur_joint) < 2 * len(cur_grain):
            total_missing, _, miss_case = check_connectivity(cur_joint)
            for arg, coor in del_joints.items():
                cur_joint[arg] = coor
                total_new, _, miss_case = check_connectivity(cur_joint)
                if total_missing <= total_new:
                    del cur_joint[arg]

        if self.BC == "periodic" and len(cur_joint) > 2 * len(cur_grain):
            total_missing, _, miss_case = check_connectivity(cur_joint)
            for key in list(miss_case.keys()):
                saved = cur_joint[key]
                del cur_joint[key]
                total_missing, _, miss_case = check_connectivity(cur_joint)
                if total_missing:
                    cur_joint[key] = saved
                else:
                    break
        return cur_joint, miss_case

    def _boundary_junctions(self, alpha, cur_joint):
        """Junctions with the boundary grain 1 where the grain id changes
        along the domain's edge."""
        m, n = alpha.shape
        s = self.imagesize[0]
        for i in range(m - 1):
            if alpha[i, 0] != alpha[i + 1, 0]:
                cur_joint[tuple(sorted([1, alpha[i, 0], alpha[i + 1, 0]]))] = [i / s, 0, 3]
            if alpha[i, -1] != alpha[i + 1, -1]:
                cur_joint[tuple(sorted([1, alpha[i, -1], alpha[i + 1, -1]]))] = [i / s, n / s, 3]
        for i in range(n - 1):
            if alpha[0, i] != alpha[0, i + 1]:
                cur_joint[tuple(sorted([1, alpha[0, i], alpha[0, i + 1]]))] = [0, i / s, 3]
            if alpha[-1, i] != alpha[-1, i + 1]:
                cur_joint[tuple(sorted([1, alpha[-1, i], alpha[-1, i + 1]]))] = [m / s, i / s, 3]

    # ------------------------------------------------------------------
    # the trajectory
    # ------------------------------------------------------------------
    def extract(self, rawdat_dir: str, cache_dir: str = "./data_cache"):
        """load_pf_file, then extract_frames."""
        self.load_pf_file(rawdat_dir, cache_dir)
        self.extract_frames()

    def extract_frames(self):
        """Follow the loaded PF simulation over load_frames frames: each
        frame's areas and eliminated grains, and with match_graph (or at
        frame 0) its junctions matched to the graph and its state."""
        prev_joint = {k: [0, 0, 100] for k in self.joint2vertex}
        prev_grain = set(np.arange(self.num_regions) + 1)

        for frame in range(self.load_frames):
            self._log(f"load frame {frame}")
            self.alpha_pde = self.alpha_pde_frames[:, :, frame].T
            ids, counts = np.unique(self.alpha_pde, return_counts=True)
            self.area_counts = dict(zip(ids, counts))
            self.area_traj.append(self.area_counts)
            cur_grain = set(ids)
            if self.BC == "noflux":
                cur_grain.add(1)
            eliminated = prev_grain - cur_grain
            self.grain_events.append(eliminated)
            prev_grain = cur_grain

            if frame > 0 and not self.match_graph:
                continue

            cur_joint, miss_case = self._detect_junctions(frame, prev_joint,
                                                          cur_grain)
            self._log(f"grains {len(cur_grain)}, junctions {len(cur_joint)}")
            if not cur_grain:
                raise ValueError(f"frame {frame} holds no grain")

            if self.BC == "periodic" and (
                    len(cur_joint) != 2 * len(cur_grain) or len(miss_case) > 0):
                self._log("junction find failed: frame quarantined")
                self.edge_events.append(set())
                self.save_frame[frame] = False
                self.states.append(heterograph.tensorize(self, frame))
                continue

            prev_joint = cur_joint
            self.match_frame(frame, cur_joint, eliminated)
            self.rebuild_regions()
            self.states.append(heterograph.tensorize(self, frame))

    # ------------------------------------------------------------------
    # the difference between frames: E0, E1, E2
    # ------------------------------------------------------------------
    def match_frame(self, frame: int, cur_joint, eliminated_grains):
        switching_edges: Set[Tuple[int, int]] = set()

        for k, v in cur_joint.items():
            cur_joint[k] = v[:2]
        old_vertices = dict(self.vertices)
        self.vertices = {}

        def unmatched():
            old_map = {k: v for k, v in self.joint2vertex.items()
                       if k not in cur_joint}
            new_map = {k: v for k, v in cur_joint.items()
                       if k not in self.joint2vertex}
            return old_map, new_map

        old_map, new_map = unmatched()

        # ---- E1: neighbor switching --------------------------------------
        old_set, new_set = set(old_map), set(new_map)
        if old_set != new_set:
            old_joint = list(old_set - new_set)
            new_joint = list(new_set - old_set)
            quad_old = _quadruple_keys(old_joint)
            quad_new = _quadruple_keys(new_joint)
            for quad in set(quad_old) & set(quad_new):
                oi, oj = quad_old[quad]
                ni, nj = quad_new[quad]
                oi_x = old_vertices[self.joint2vertex[oi]]
                oj_x = old_vertices[self.joint2vertex[oj]]
                ni_x, nj_x = cur_joint[ni][:2], cur_joint[nj][:2]
                if abs(_relative_angle(oi_x, oj_x)
                       - _relative_angle(ni_x, nj_x)) > math.pi / 2:
                    ni, nj = nj, ni
                vi, vj = self.joint2vertex[oi], self.joint2vertex[oj]
                switching_edges.add((vi, vj))
                switching_edges.add((vj, vi))
                self._switch(oi, oj, ni, nj, old_joint, new_joint)

        # ---- E2: grain elimination (incl. merged groups) -----------------
        old_map, new_map = unmatched()
        grain_neigh = {}
        for g in eliminated_grains:
            junction = set()
            for k in self.joint2vertex:
                if g in set(k):
                    junction.update(set(k))
            junction.discard(g)
            grain_neigh[g] = junction

        merged = {}
        visited = set()
        for k1, v1 in grain_neigh.items():
            ks, vs = [k1], v1
            for k2, v2 in grain_neigh.items():
                if k1 != k2 and k2 not in visited and k1 in v2:
                    ks.append(k2)
                    vs.update(v2)
                    visited.add(k2)
            if k1 not in visited:
                merged[tuple(ks)] = vs
            visited.add(k1)

        for elim_group, junction in merged.items():
            self._eliminate_group(elim_group, junction, new_map)

        self.edge_events.append(switching_edges)

        # ---- E0: apply measured coordinates, repair stragglers -----------
        todelete = []
        for joint in self.joint2vertex:
            if joint in cur_joint:
                vert = self.joint2vertex[joint]
                coors = cur_joint[joint]
                if self.BC == "periodic":
                    self.vertices[vert] = periodic_move_pt(list(coors),
                                                           old_vertices[vert])
                else:
                    self.vertices[vert] = coors
            else:
                self._log("disappeared joint dropped:", joint)
                todelete.append(joint)
        for joint in todelete:
            del self.joint2vertex[joint]
        for joint in cur_joint:
            if joint not in self.joint2vertex:
                self._log("emerged joint added:", joint)
                self.joint2vertex[joint] = self.num_vertices
                self.vertices[self.num_vertices] = cur_joint[joint]
                self.num_vertices += 1

        self.vertex2joint = {v: k for k, v in self.joint2vertex.items()}

        # edge repair: every junction pair sharing two grains is linked
        for k1, v1 in self.joint2vertex.items():
            for k2, v2 in self.joint2vertex.items():
                if k1 != k2 and shares_two_grains(k1, k2):
                    if [v1, v2] not in self.edges:
                        self.edges.append([v1, v2])
        for i, (src, dst) in enumerate(self.edges):
            if src > -1:
                if src in self.vertex2joint and dst in self.vertex2joint:
                    if not shares_two_grains(self.vertex2joint[src],
                                             self.vertex2joint[dst]):
                        self.edges[i] = [-1, -1]
                else:
                    self.edges[i] = [-1, -1]

    def _switch(self, old_i, old_j, new_i, new_j, old_joint, new_joint):
        """Rewire one neighbour-switching event: the two junctions keep
        their vertices and trade one neighbour each."""
        vi = self.joint2vertex[old_i]
        vj = self.joint2vertex[old_j]
        N_i = [e[0] for e in self.edges if e[1] == vi]
        N_j = [e[0] for e in self.edges if e[1] == vj]
        N_i.remove(vj)
        N_j.remove(vi)
        if len(set(self.vertex2joint[N_i[1]]) & set(new_i)) == 2:
            N_i.reverse()
        if len(set(self.vertex2joint[N_j[1]]) & set(new_j)) == 2:
            N_j.reverse()

        self.edges[self.edges.index([vi, N_i[1]])] = [vi, N_j[1]]
        self.edges[self.edges.index([vj, N_j[1]])] = [vj, N_i[1]]
        self.edges[self.edges.index([N_i[1], vi])] = [N_j[1], vi]
        self.edges[self.edges.index([N_j[1], vj])] = [N_i[1], vj]

        self.joint2vertex[new_i] = self.joint2vertex.pop(old_i)
        self.joint2vertex[new_j] = self.joint2vertex.pop(old_j)
        self._log((vi, vj), "switch:", old_i, old_j, "->", new_i, new_j)

        for j in (old_i, old_j):
            if j in old_joint:
                old_joint.remove(j)
        for j in (new_i, new_j):
            if j in new_joint:
                new_joint.remove(j)

    def _eliminate_group(self, elim_group, junction, new_map):
        """Remove a (possibly merged) group of vanishing grains and stitch
        the ring around them back together."""
        old_vert, toadd = [], []
        todelete = set()
        for k, v in self.joint2vertex.items():
            if len(set(elim_group) & set(k)) > 0:
                old_vert.append(v)
                todelete.add(k)
        for k in new_map:
            if set(k).issubset(junction):
                toadd.append(k)

        if len(old_vert) != len(toadd) + 2:
            return

        visited_joint = {}
        remove_vert = []
        for vert in old_vert:
            n_vert = [e[0] for e in self.edges if e[1] == vert]
            for neigh in n_vert:
                if neigh not in old_vert:
                    for joint in toadd:
                        if len(set(joint) & set(self.vertex2joint[neigh])) == 2:
                            if joint in visited_joint:
                                remove_vert.append([vert, visited_joint[joint]])
                            else:
                                visited_joint[joint] = vert
                                break

        self._log(elim_group, "eliminated, sides", len(todelete))
        for k in todelete:
            del self.joint2vertex[k]
        for joint, vert in visited_joint.items():
            self.joint2vertex[joint] = vert

        for v1 in old_vert:
            for v2 in old_vert:
                if [v1, v2] in self.edges:
                    self.edges[self.edges.index([v1, v2])] = [-1, -1]
                    self.edges[self.edges.index([v2, v1])] = [-1, -1]
        for k1 in visited_joint:
            for k2 in visited_joint:
                if k1 != k2 and len(set(k1) & set(k2)) == 2:
                    v1, v2 = visited_joint[k1], visited_joint[k2]
                    if [v1, v2] not in self.edges:
                        self.edges.append([v1, v2])
                        self.edges.append([v2, v1])

        def elim_edge(o1, o2, r1):
            n1 = [i for i, e in enumerate(self.edges) if e[1] == o1]
            for i in n1:
                src = self.edges[i][0]
                if src == o2:
                    self.edges[i] = [-1, -1]
                elif src in old_vert:
                    idx = self.edges.index([o1, src])
                    self.edges[i] = [-1, -1]
                    self.edges[idx] = [-1, -1]
                else:
                    idx = self.edges.index([o1, src])
                    self.edges[i] = [src, r1]
                    self.edges[idx] = [r1, src]

        # a ring that cannot be stitched (fewer than two merge points, or
        # an edge missing) is left as it stands: such frames are tolerated,
        # not fatal
        try:
            o1, o2 = remove_vert[0][0], remove_vert[1][0]
            r1, r2 = remove_vert[0][1], remove_vert[1][1]
            old_vert.remove(o1)
            old_vert.remove(o2)
            elim_edge(o1, o2, r1)
            elim_edge(o2, o1, r2)
        except (IndexError, ValueError):
            pass


def generate(lxd: float, seed: int, G: float, R: float,
             bc: str = "periodic") -> TrajectoryExtractor:
    """The generate-mode trajectory of (lxd, seed, G, R): the seeded
    Voronoi microstructure with its frame-0 areas from the raster and its
    frame-0 state (make_test_sample makes the t=0 sample of it)."""
    traj = TrajectoryExtractor(lxd=lxd, seed=seed, frames=121, bc=bc,
                               physical_params={"G": G, "R": R})
    traj.area_counts = dict(zip(*np.unique(traj.alpha_field,
                                           return_counts=True)))
    traj.area_traj.append(dict(traj.area_counts))
    traj.states.append(heterograph.tensorize(traj, 0))
    return traj


SPAN_CHOICES = (6, 8, 10, 12, 15, 20, 24, 30, 40, 60, 120)


def calibrate_span(traj: TrajectoryExtractor) -> int:
    """The largest window in SPAN_CHOICES shorter than both the edge-event
    and the grain-event spacing of the trajectory."""
    edge_e = len(set.union(*traj.edge_events)) if traj.edge_events else 0
    grain_e = len(set.union(*traj.grain_events)) if traj.grain_events else 0
    edge_step = 6 * 360 / edge_e if edge_e > 0 else 1000
    grain_step = 6 * 90 / grain_e if grain_e > 0 else 1000
    span = SPAN_CHOICES[0]
    for c in SPAN_CHOICES:
        if c < edge_step and c < grain_step:
            span = c
    return span


def make_training_samples(
    traj: TrajectoryExtractor, span: int | None = None, prev: int = 0,
    stride: int | None = None, verbose: bool = False,
) -> List[heterograph.HeteroState]:
    """Windowed training pairs with event labels and optional history
    gradients. `stride` defaults to span // 2; stride=1 gives the densest
    overlapping window set a trajectory supports."""
    span = span or calibrate_span(traj)
    stride = stride if stride is not None else max(1, span // 2)
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    samples: List[heterograph.HeteroState] = []
    success_list: List[int] = []
    cnt = 0
    for snapshot in range(0, traj.frames - span, stride):
        cnt += 1
        if not (traj.save_frame[snapshot] and traj.save_frame[snapshot + span]):
            continue
        if snapshot - span >= 0 and not traj.save_frame[snapshot - span]:
            continue
        hg = traj.states[snapshot]
        hg.span = span
        event_list = set.union(*traj.edge_events[snapshot + 1: snapshot + span + 1])
        elim_list = []
        for checkpoint in range(snapshot + 1, snapshot + span + 1):
            for grain in traj.grain_events[checkpoint]:
                elim_list.append([grain - 1, span / (checkpoint - snapshot)])
        heterograph.form_gradient(
            hg,
            prev=None if snapshot - span < 0 else traj.states[snapshot - span],
            nxt=traj.states[snapshot + span],
            event_list=event_list,
            elim_list=elim_list,
            verbose=verbose,
        )
        samples.append(hg)
        success_list.append(cnt)

    for idx, hg in enumerate(samples):
        frame = success_list[idx]
        prev_list = []
        for i in range(1, prev + 1):
            if frame - i in success_list:
                prev_list.append(samples[success_list.index(frame - i)])
            else:
                prev_list.append(None)
        heterograph.append_history(hg, prev_list)
    return samples


def make_test_sample(traj: TrajectoryExtractor,
                     span: int) -> heterograph.HeteroState:
    """The t=0 inference input: the first state with its gradient
    features (zero: no previous window) and the window `span`."""
    hg0 = traj.states[0]
    hg0.span = span
    heterograph.form_gradient(hg0, prev=None, nxt=None, event_list=None,
                              elim_list=None)
    heterograph.append_history(hg0, [])
    return hg0
