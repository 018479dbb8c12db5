"""The port's planar graph (graph/planar) against the JAX package's: the
point helpers, region rebuild and the raster, which the JAX package paints
with Pillow and the port with its own numpy scanline fill. The raster must
be pixel-equal: on Voronoi graphs of both boundary conditions, on graphs
reconstructed after three spans of the port's CPU rollout (wrapped,
irregular polygons), and on drawn integer polygons against Pillow
directly."""

import math

import numpy as np
import PIL.Image
import PIL.ImageDraw
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from graingraphnn_torch.graph import geometry
from graingraphnn_torch.graph import planar as tp
from graingraphnn_torch.graph import voronoi as tv
from graingraphnn_torch.rollout import device_driver as dd
from graingraphnn_torch.rollout import device_rollout as dr
from graingraphnn_torch.train import checkpoint
from graingraphnn_tpu.graph import geometry as jgeometry
from graingraphnn_tpu.graph import planar as jp
from graingraphnn_tpu.graph import voronoi as jv
from graingraphnn_tpu.train import checkpoint as jck
from tests.test_torch_device_rollout import REPO

GRAPHS = [dict(lxd=40, seed=3), dict(lxd=40, seed=1, bc="noflux"),
          dict(lxd=60, seed=7, adjust_grain_size=True,
               adjust_grain_orien=True),
          dict(lxd=120, seed=5)]


def pil_paint(height, width, rings):
    """Pillow's fill of the rings in order, each with its index + 1, as the
    JAX package's raster encodes ids; -1 where none painted."""
    im = PIL.Image.new("RGB", (width, height))
    draw = PIL.ImageDraw.Draw(im)
    for k, ring in enumerate(rings):
        v = k + 1
        draw.polygon([tuple(int(c) for c in p) for p in ring],
                     fill=(v // 65025, (v % 65025) // 255, v % 255))
    a = np.array(im, dtype=int)
    return a[:, :, 0] * 65025 + a[:, :, 1] * 255 + a[:, :, 2] - 1


def ccw_ring(points):
    """The vertex order PlanarGraph.rasterize draws: by angle about the
    ring's mean."""
    c = np.mean(np.asarray(points, float), axis=0)
    return sorted(points, key=lambda p: tp.ccw_key(p, c))


def copy_graph(src, dst):
    for k in ("vertices", "joint2vertex", "vertex2joint", "edges",
              "quadruples", "corner_grains", "max_y"):
        setattr(dst, k, getattr(src, k))


def test_point_helpers_match_jax():
    rng = np.random.default_rng(0)
    for _ in range(200):
        p, pc = rng.uniform(-0.2, 1.2, 2).tolist(), rng.uniform(0, 1, 2).tolist()
        assert tp.periodic_move_pt(list(p), pc) == jp.periodic_move_pt(
            list(p), pc)
        assert tp.periodic_dist_pt(p, pc) == jp.periodic_dist_pt(p, pc)
        assert tp.ccw_key(p, pc) == jp.ccw_key(p, pc)
    assert tp.ccw_key([0.3, 0.3], [0.3, 0.3]) == jp.ccw_key([0.3, 0.3],
                                                            [0.3, 0.3])
    for a, b in (((1, 2, 3), (2, 3, 4)), ((1, 2, 3), (3, 4, 5)),
                 ((1, 2, 3), (1, 2, 3))):
        assert tp.shares_two_grains(a, b) == jp.shares_two_grains(a, b)


def test_periodic_move_and_unit_match_jax():
    rng = np.random.default_rng(1)
    p = rng.uniform(-0.3, 1.3, (64, 2)).astype(np.float32)
    pc = rng.uniform(0, 1, (64, 2)).astype(np.float32)
    pc[0] = p[0]                                   # zero length: eps floor
    for name in ("periodic_move", "periodic_unit"):
        a = getattr(geometry, name)(torch.from_numpy(p), torch.from_numpy(pc))
        b = getattr(jgeometry, name)(p, pc)
        np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)


@pytest.mark.parametrize("kw", GRAPHS, ids=lambda kw: "-".join(
    f"{k}={v}" for k, v in kw.items()))
def test_rebuild_and_raster_match_jax_on_voronoi_graphs(kw):
    """The JAX Microstructure's junction graph, rebuilt and rasterised by
    both packages' PlanarGraph."""
    m = jv.Microstructure(**kw)
    a = jp.PlanarGraph(bc=m.BC, imagesize=m.imagesize)
    b = tp.PlanarGraph(bc=m.BC, imagesize=m.imagesize)
    for g in (a, b):
        copy_graph(m, g)
        g.edges = []
        g.rebuild_regions(init_edges=True)
    for k in ("regions", "region_coors", "region_center", "edges",
              "vertex_neighbor", "corner_grains"):
        assert getattr(a, k) == getattr(b, k), k
    np.testing.assert_array_equal(b.rasterize(), a.rasterize())
    np.testing.assert_array_equal(b.alpha_field, m.alpha_field)
    # a finer and a coarser raster of the same polygons
    for size in (int(m.imagesize[0] * 1.5), m.imagesize[0] // 2):
        shape = (size, int(size * m.max_y))
        np.testing.assert_array_equal(b.rasterize(shape), a.rasterize(shape))
    truth = np.roll(a.alpha_field, 3, axis=0)
    assert b.layer_error(truth) == a.layer_error(truth)


@pytest.fixture(scope="module")
def rolled_graph():
    """A 40 um graph after three spans of the port's CPU rollout with the
    shipped checkpoints, as the driver observes it: junction positions
    unscaled, rings from E_pq, edges from E_pp."""
    traj = dd.generate_trajectory(40, 3, 4.0, 1.0)
    mp = REPO + "/artifacts/40um/"
    pr, hpr, _ = jck.load(mp + "regressor0")
    pc, hpc, _ = jck.load(mp + "classifier1")
    reg = checkpoint.params_from_jax(pr, hpr, "cpu")
    cls = checkpoint.params_from_jax(pc, hpc, "cpu")
    st, _, _ = dd.init_scaled_state(traj.x, traj.edges, traj.mask, traj.lxd,
                                    traj.patch_size, device="cpu")
    run = dr.make_rollout(reg, cls, n_steps=3, c_threshold=0.99)
    st, aux = run(st)
    assert int((aux["switching"][..., 0] >= 0).sum()) > 0
    xj = st.xj.numpy().astype(np.float64)
    mj, E_pq, E_pp = st.mask_j.numpy(), st.E_pq.numpy(), st.E_pp.numpy()
    v2j = {}
    for j, g in E_pq[:, E_pq[0] >= 0].T.tolist():
        v2j.setdefault(j, set()).add(g + 1)
    return {
        "vertices": {i: xj[i, :2].tolist() for i in range(len(xj))
                     if mj[i] == 1},
        "joint2vertex": {tuple(sorted(v)): k for k, v in v2j.items()},
        "edges": E_pp[:, E_pp[0] >= 0].T.tolist(),
        "imagesize": traj.imagesize,
    }


@pytest.mark.parametrize("mesh", [0.08, 0.05])
def test_raster_matches_jax_after_three_spans(rolled_graph, mesh):
    g = rolled_graph
    a = jp.PlanarGraph(imagesize=g["imagesize"])
    b = tp.PlanarGraph(imagesize=g["imagesize"])
    for pg in (a, b):
        pg.raise_err = False
        pg.vertices = dict(g["vertices"])
        pg.joint2vertex = dict(g["joint2vertex"])
        pg.vertex2joint = {v: k for k, v in pg.joint2vertex.items()}
        pg.edges = [list(e) for e in g["edges"]]
        pg.rebuild_regions()
    assert a.region_coors == b.region_coors
    # rings that wrap the periodic boundary are painted past the unit cell
    assert max(max(c[0] for c in r) for r in b.region_coors.values()) > 1
    size = int(40 / mesh) + 1
    np.testing.assert_array_equal(b.rasterize((size, size)),
                                  a.rasterize((size, size)))


@settings(max_examples=400, deadline=None)
@given(st.integers(4, 70), st.integers(4, 70),
       st.lists(st.lists(st.tuples(st.integers(-12, 80), st.integers(-12, 80)),
                         min_size=2, max_size=12),
                min_size=1, max_size=8),
       st.sampled_from(["drawn", "ccw", "cw"]))
def test_fill_matches_pillow_on_drawn_polygons(height, width, rings, order):
    """Integer rings in the order drawn (self-intersecting ones included),
    or in rasterize's vertex order (by angle about their mean) or its
    reverse; coincident vertices, rings off the canvas and overlapping
    rings included."""
    if order != "drawn":
        rings = [ccw_ring(r)[::-1] if order == "cw" else ccw_ring(r)
                 for r in rings]
    np.testing.assert_array_equal(
        tp.paint_polygons(height, width, rings),
        pil_paint(height, width, rings))


def test_fill_matches_pillow_on_small_jittered_cells():
    """Many small rings of a few pixels, whose corners the fill's joined
    corner rule decides."""
    rng = np.random.default_rng(7)
    rings = []
    for _ in range(400):
        c = rng.uniform(-3, 63, 2)
        n = int(rng.integers(3, 9))
        ang = np.sort(rng.uniform(0, 2 * math.pi, n))
        r = rng.uniform(0.4, 4.5, n)
        pts = [(int(c[0] + q * math.cos(t)), int(c[1] + q * math.sin(t)))
               for t, q in zip(ang, r)]
        rings.append(ccw_ring(pts))
    np.testing.assert_array_equal(tp.paint_polygons(60, 60, rings),
                                  pil_paint(60, 60, rings))


def test_raster_matches_jax_at_a_fine_mesh():
    """The port's periodic 40 um graph painted at mesh 0.02 (2001 pixels,
    rings ~200 pixels across) by both packages."""
    m = tv.Microstructure(lxd=40, seed=3)
    a = jp.PlanarGraph(imagesize=m.imagesize)
    copy_graph(m, a)
    a.region_coors = m.region_coors
    size = int(40 / 0.02) + 1
    np.testing.assert_array_equal(m.rasterize((size, size)),
                                  a.rasterize((size, size)))
