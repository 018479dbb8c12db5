"""The port's float64 host topology editor (graingraphnn_torch/rollout/
topology.py) against the JAX package's on the same numpy inputs, on the
generated 40 um graphs (periodic and no-flux): the cases of
tests/test_topology.py (no-op, one switch, an elimination, nucleation
with default_rng(0)), random switches and eliminations, and one span of
predictions from the shipped weights. Outputs are bit-equal: edges,
masks, switches, forced eliminations, features and the rng's state after
the call. The graph invariants (3 jj and 3 jg edges a live junction,
symmetric jj edges, Euler's V - E + F on the torus) hold after each edit.
Also the numpy geometry helpers the editor uses."""

import copy
import os

import numpy as np
import pytest

from graingraphnn_torch.graph import geometry as tgeo
from graingraphnn_torch.graph import schema
from graingraphnn_torch.rollout.topology import TopologyEditor
from graingraphnn_tpu.graph import geometry as jgeo
from graingraphnn_tpu.rollout.topology import TopologyEditor as JaxEditor
from tests.test_torch_engine import REPO, trajectories


def graph(bc="periodic", seed=5):
    """x, edges, mask of a generated 40 um t=0 sample, in the engine's
    host layout."""
    _, hg, _, _ = trajectories(bc, seed=seed)
    x = {k: np.array(hg.feature_dicts[k], np.float64)
         for k in ("grain", "joint")}
    edges = {k: np.array(hg.edge_index_dicts[et], np.int64)
             for k, et in zip(("push", "pull", "connect"), schema.EDGE_TYPES)}
    edges["connect"] = edges["connect"][:, edges["connect"][0] > -1]
    mask = {"grain": np.array(hg.mask["grain"], np.int64).reshape(-1, 1),
            "joint": np.ones((len(x["joint"]), 1), np.int64)}
    return x, edges, mask


def neutral_pred(x, edges):
    return {
        "joint": np.zeros((len(x["joint"]), 2)),
        "grain": np.stack([np.full(len(x["grain"]), -0.5),
                           np.zeros(len(x["grain"]))], axis=1),
        "grain_area": x["grain"][:, 3].copy(),
        "edge_event": np.full(edges["connect"].shape[1], -50.0),
        "grain_event": np.array([], dtype=np.int64),
    }


def both(x, edges, pred, mask, threshold=0.6, seed=0, **kw):
    """The JAX and the port editor on copies of the same inputs: a pair
    of (x, edges, switching, extra, mask, pred, next rng draw)."""
    out = []
    for cls in (JaxEditor, TopologyEditor):
        ed = cls(threshold=threshold, rng=np.random.default_rng(seed))
        args = copy.deepcopy((x, edges, pred, mask))
        res = ed.update(*args, **kw)
        out.append((*res, args[3], args[2], ed.rng.random()))
    return out


def assert_equal(j, t):
    (jx, je, jsw, jev, jm, jp, jr), (tx, te, tsw, tev, tm, tp, tr) = j, t
    for k in jx:
        np.testing.assert_array_equal(tx[k], jx[k], err_msg=k)
    assert set(te) == set(je)
    for k in je:
        np.testing.assert_array_equal(te[k], je[k], err_msg=k)
    for k in jm:
        np.testing.assert_array_equal(tm[k], jm[k], err_msg=k)
    np.testing.assert_array_equal(tsw, jsw)
    np.testing.assert_array_equal(tev, jev)
    np.testing.assert_array_equal(tp["joint"], jp["joint"])
    assert tr == jr


def check_invariants(edges, mask, bc):
    live_j = np.nonzero(mask["joint"][:, 0])[0]
    live_g = np.nonzero(mask["grain"][:, 0])[0]
    jj, jg = edges["connect"], edges["pull"]
    n = len(mask["joint"])
    src = np.bincount(jj[0], minlength=n)
    dst = np.bincount(jj[1], minlength=n)
    jgc = np.bincount(jg[0], minlength=n)
    assert (src[live_j] == 3).all() and (dst[live_j] == 3).all()
    assert (jgc[live_j] == 3).all()
    dead = np.setdiff1d(np.arange(n), live_j)
    assert (src[dead] == 0).all()
    pairs = set(map(tuple, jj.T.tolist()))
    assert all((b, a) in pairs for a, b in pairs)
    if bc == "periodic":
        assert len(live_j) - jj.shape[1] // 2 + len(live_g) == 0
    assert np.array_equal(edges["push"], edges["pull"][::-1])


@pytest.mark.parametrize("bc", ["periodic", "noflux"])
def test_noop_update_matches_jax(bc):
    x, edges, mask = graph(bc)
    j, t = both(x, edges, neutral_pred(x, edges), mask)
    assert_equal(j, t)
    assert len(t[2]) == 0 and len(t[3]) == 0
    np.testing.assert_array_equal(t[1]["connect"], edges["connect"])
    check_invariants(t[1], t[4], bc)


@pytest.mark.parametrize("bc", ["periodic", "noflux"])
def test_one_switch_matches_jax(bc):
    x, edges, mask = graph(bc)
    y = neutral_pred(x, edges)
    jj = edges["connect"]
    cand = np.nonzero((jj[0] < jj[1]) & (jj[0] > 0))[0][0]
    p1, p2 = int(jj[0, cand]), int(jj[1, cand])
    y["edge_event"][cand] = 50.0
    y["joint"] = np.random.default_rng(1).uniform(-0.5, 0.5, y["joint"].shape)
    j, t = both(x, edges, y, mask)
    assert_equal(j, t)
    assert len(t[2]) == 1
    check_invariants(t[1], t[4], bc)
    # the pair's gradient features are zeroed, as the reference's aliased
    # rewrite leaves them
    assert np.all(t[0]["joint"][[p1, p2], 6:8] == 0.0)


@pytest.mark.parametrize("bc", ["periodic", "noflux"])
def test_elimination_of_the_smallest_ring_matches_jax(bc):
    x, edges, mask = graph(bc)
    jg = edges["pull"]
    grains, counts = np.unique(jg[1], return_counts=True)
    keep = grains > 0 if bc == "noflux" else grains >= 0
    g = int(grains[keep][np.argmin(counts[keep])])
    y = neutral_pred(x, edges)
    y["grain_event"] = np.array([g])
    j, t = both(x, edges, y, mask)
    assert_equal(j, t)
    assert t[4]["grain"][g, 0] == 0
    n_before = int(mask["joint"].sum())
    assert int(t[4]["joint"].sum()) == n_before - 2 * (1 + len(t[3]))
    check_invariants(t[1], t[4], bc)


@pytest.mark.parametrize("bc", ["periodic", "noflux"])
def test_nucleation_matches_jax(bc):
    """default_rng(0) with p = 0.005: grains and junction pairs inserted
    at the same sites, and the rng left in the same state."""
    x, edges, mask = graph(bc)
    ng, nj = len(x["grain"]), len(x["joint"])
    j, t = both(x, edges, neutral_pred(x, edges), mask, seed=0,
                nucleation_prob=0.005)
    assert_equal(j, t)
    added = len(t[0]["grain"]) - ng
    assert added >= 1 and len(t[0]["joint"]) == nj + 2 * added
    check_invariants(t[1], t[4], bc)


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("bc", ["periodic", "noflux"])
def test_random_switches_and_eliminations_match_jax(bc, seed):
    """Random logits over the threshold on ~15 % of the edges, the
    smallest grains eliminated in order of area, random displacements and
    darea; with seed 5 also nucleation."""
    x, edges, mask = graph(bc, seed=5 + seed % 3)
    rng = np.random.default_rng(seed)
    E = edges["connect"].shape[1]
    ng = len(x["grain"])
    y = {
        "joint": rng.uniform(-0.9, 0.9, (len(x["joint"]), 2)),
        "grain": rng.uniform(-0.9, 0.9, (ng, 2)),
        "grain_area": x["grain"][:, 3] + rng.uniform(-2e-3, 2e-3, ng),
        "edge_event": rng.normal(-3.0, 3.0, E),
    }
    cand = np.nonzero(y["grain_area"] < np.quantile(y["grain_area"], 0.08))[0]
    cand = cand[np.argsort(y["grain_area"][cand])]
    y["grain_event"] = cand[cand != 0] if bc == "noflux" else cand
    kw = {"nucleation_prob": 0.01} if seed == 5 else {}
    j, t = both(x, edges, y, mask, threshold=0.6, seed=seed, **kw)
    assert_equal(j, t)
    assert len(t[2]) > 0 and int((t[4]["grain"] == 0).sum()) > int(
        (mask["grain"] == 0).sum())
    check_invariants(t[1], t[4], bc)


@pytest.mark.parametrize("bc", ["periodic", "noflux"])
def test_windowed_edit_matches_jax(bc):
    """The moving melt pool's active windows: grains and junctions with
    x > 0.5 are frozen."""
    x, edges, mask = graph(bc)
    rng = np.random.default_rng(7)
    y = neutral_pred(x, edges)
    y["edge_event"] = rng.normal(-2.0, 3.0, edges["connect"].shape[1])
    y["grain_event"] = np.argsort(x["grain"][:, 3])[1:8]
    j, t = both(x, edges, y, mask, active_grains=x["grain"][:, 0] < 0.5,
                active_joints=x["joint"][:, 0] < 0.5)
    assert_equal(j, t)
    assert len(t[2]) > 0
    check_invariants(t[1], t[4], bc)


@pytest.fixture(scope="module")
def shipped_pred():
    """One span of predictions of the shipped checkpoints on the generated
    40 um graph (seed 3, G 4, R 1), through the port's engine on the CPU,
    with the span's integration applied as the engine applies it."""
    from graingraphnn_torch.rollout.engine import RolloutEngine
    from graingraphnn_torch.train import checkpoint

    path = os.path.join(REPO, "artifacts", "40um")
    reg, _, _ = checkpoint.load_model(os.path.join(path, "regressor0"), "cpu")
    cls, _, _ = checkpoint.load_model(os.path.join(path, "classifier1"),
                                      "cpu")
    _, _, tt, th = trajectories(seed=3)
    eng = RolloutEngine(reg, cls, device="cpu")
    seen = {}

    def keep(x, edges, pred, mask, **kw):
        seen["args"] = copy.deepcopy((x, edges, pred, mask))
        return TopologyEditor.update(eng.editor, x, edges, pred, mask, **kw)

    eng.editor.update = keep
    eng.run(th, tt, span=6, compare=False, growth_height=2.6)
    return seen["args"]


@pytest.mark.parametrize("threshold,r_threshold", [(0.99, 1e-4), (0.9, 6e-3),
                                                   (0.8, 7e-3)])
def test_shipped_span_matches_jax(shipped_pred, threshold, r_threshold):
    x, edges, pred, mask = shipped_pred
    pred = dict(pred)
    live = mask["grain"][:, 0] > 0
    cand = np.nonzero(live & (pred["grain_area"] < r_threshold))[0]
    pred["grain_event"] = cand[np.argsort(pred["grain_area"][cand])]
    j, t = both(x, edges, pred, mask, threshold=threshold)
    assert_equal(j, t)
    if threshold < 0.99:       # the checkpoint's own 0.99 switches none here
        assert len(t[2]) > 0 and len(pred["grain_event"]) > 0
    check_invariants(t[1], t[4], "periodic")


@pytest.mark.parametrize("seed", range(4))
def test_geometry_helpers_match_jax(seed):
    """point_in_triangle, in_bound and periodic_dist_np on random points
    across the periodic seam."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-0.1, 1.1, (400, 4, 2))
    for t, a, b, c in pts:
        assert tgeo.point_in_triangle(t, a, b, c) == jgeo.point_in_triangle(
            t, a, b, c)
        assert tgeo.periodic_dist_np(t, a) == jgeo.periodic_dist_np(t, a)
        assert tgeo.in_bound(*t, max_y=0.9) == jgeo.in_bound(*t, max_y=0.9)
    # points on a triangle's edge and vertex count as inside
    tri = np.array([[0.1, 0.1], [0.5, 0.1], [0.1, 0.5]])
    assert tgeo.point_in_triangle([0.3, 0.1], *tri)
    assert tgeo.point_in_triangle([0.1, 0.1], *tri)
