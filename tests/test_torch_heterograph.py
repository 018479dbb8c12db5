"""The port's heterograph and generate-mode extraction (data/heterograph,
data/extraction) against the JAX package's: tensorize on periodic and
no-flux graphs, form_gradient and append_history on perturbed snapshots,
windowed training samples, the t=0 test sample, and the device state
straight from it (state_from_heterograph), with and without the
persistent ELL column tables."""

import copy
import types

import numpy as np
import pytest

from graingraphnn_torch.data import extraction as tex
from graingraphnn_torch.data import heterograph as thg
from graingraphnn_torch.rollout import device_rollout as tdr
from graingraphnn_tpu.data import extraction as jex
from graingraphnn_tpu.data import heterograph as jhg
from graingraphnn_tpu.rollout import device_rollout as jdr

FIELDS = ("xg", "xj", "E_pp", "E_pq", "mask_g", "mask_j", "n_pp",
          "pull_cols", "push_cols", "connect_cols", "n_g", "n_j", "n_pq")


def assert_same_state(a, b):
    """Two HeteroStates (any package) hold equal dicts and arrays."""
    for k in ("features", "targets", "targets_scaling", "edge_type",
              "physical_params", "edges", "vertex2joint", "span"):
        assert getattr(a, k) == getattr(b, k), k
    for k in ("feature_dicts", "target_dicts", "edge_index_dicts",
              "edge_weight_dicts", "mask"):
        da, db = getattr(a, k), getattr(b, k)
        assert da.keys() == db.keys(), k
        for kk in da:
            assert np.asarray(da[kk]).dtype == np.asarray(db[kk]).dtype, kk
            np.testing.assert_array_equal(da[kk], db[kk], err_msg=f"{k}{kk}")
    for k in ("prev_grad_grain", "prev_grad_joint"):
        if hasattr(b, k):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


@pytest.fixture(scope="module", params=["periodic", "noflux"])
def traj(request):
    t = jex.TrajectoryExtractor(lxd=40, seed=3, frames=13, bc=request.param,
                                physical_params={"G": 4.0, "R": 1.0})
    t.area_counts = dict(zip(*np.unique(t.alpha_field, return_counts=True)))
    t.extraV_frames = np.random.default_rng(0).uniform(
        0, 50, (t.num_regions, t.frames))
    return t


def snapshot(traj, k):
    """Frame k's snapshot: junctions moved a little, areas changed, one
    junction's grain triple and one edge changed from frame 1 on."""
    rng = np.random.default_rng(k)
    s = types.SimpleNamespace(**{a: copy.deepcopy(getattr(traj, a)) for a in (
        "num_regions", "num_vertices", "patch_size", "mesh_size", "frames",
        "region_center", "area_counts", "vertices", "joint2vertex", "edges",
        "theta_x", "theta_z", "physical_params", "BC", "seed",
        "extraV_frames", "vertex2joint")})
    s.vertices = {v: [c[0] + rng.uniform(-1e-3, 1e-3),
                      c[1] + rng.uniform(-1e-3, 1e-3)]
                  for v, c in s.vertices.items()}
    s.area_counts = {g: int(c * rng.uniform(0.9, 1.1))
                     for g, c in s.area_counts.items()}
    if k > 0:
        s.edges[5] = [-1, -1]
        joint = next(iter(s.vertex2joint))
        s.vertex2joint[joint] = tuple(sorted(set(s.vertex2joint[joint])
                                             - {max(s.vertex2joint[joint])}
                                             | {10_000}))
    return s


def test_tensorize_matches_jax(traj):
    for frame in (0, 4):
        snap = snapshot(traj, frame)
        assert_same_state(thg.tensorize(snap, frame),
                          jhg.tensorize(snap, frame))


def test_form_gradient_and_history_match_jax(traj):
    snaps = [snapshot(traj, k) for k in range(3)]
    states = {}
    for name, hg in (("port", thg), ("jax", jhg)):
        s0, s1, s2 = (hg.tensorize(s, 6 * k) for k, s in enumerate(snaps))
        e = s1.edges[7]
        hg.form_gradient(s0, None, s1, event_list={tuple(e)}, elim_list=[])
        hg.form_gradient(s1, s0, s2, event_list=set(), elim_list=[[3, 1.0]])
        hg.append_history(s1, [s0, None])
        states[name] = (s0, s1)
    for a, b in zip(states["port"], states["jax"]):
        assert_same_state(a, b)
    assert (states["jax"][0].target_dicts["edge_event"] == 1).sum() == 1


def fake_trajectory(traj, hg, frames=13):
    t = types.SimpleNamespace(frames=frames, save_frame=[True] * frames)
    t.save_frame[9] = False
    t.states = [hg.tensorize(snapshot(traj, k), k) for k in range(frames)]
    edges = [tuple(e) for e in traj.edges if e[0] >= 0]
    t.edge_events = [set(edges[k: k + 2]) if k % 2 else set()
                     for k in range(frames)]
    t.grain_events = [{5} if k == 4 else set() for k in range(frames)]
    return t


def test_training_samples_match_jax(traj):
    out = {}
    for name, hg, ex in (("port", thg, tex), ("jax", jhg, jex)):
        t = fake_trajectory(traj, hg)
        out[name] = (ex.calibrate_span(t),
                     ex.make_training_samples(t, span=4, prev=1),
                     ex.make_training_samples(fake_trajectory(traj, hg),
                                              span=3, prev=0, stride=1))
    assert out["port"][0] == out["jax"][0]
    for k in (1, 2):
        assert len(out["port"][k]) == len(out["jax"][k]) > 0
        for a, b in zip(out["port"][k], out["jax"][k]):
            assert_same_state(a, b)
    with pytest.raises(ValueError, match="stride"):
        tex.make_training_samples(fake_trajectory(traj, thg), span=3,
                                  stride=0)


def start(ex, hg):
    t = ex.TrajectoryExtractor(lxd=40, seed=3, frames=121,
                               physical_params={"G": 4, "R": 1})
    t.area_counts = dict(zip(*np.unique(t.alpha_field, return_counts=True)))
    t.area_traj.append(dict(t.area_counts))
    t.states.append(hg.tensorize(t, 0))
    return t, ex.make_test_sample(t, span=8)


@pytest.mark.parametrize("incremental,slack", [(False, 0), (True, 0),
                                               (True, 8)])
def test_test_sample_and_state_from_heterograph_match_jax(incremental, slack):
    _, thg0 = start(tex, thg)
    _, jhg0 = start(jex, jhg)
    assert_same_state(thg0, jhg0)
    ts = tdr.state_from_heterograph(thg0, incremental=incremental,
                                    nucleation_slack=slack, device="cpu")
    js = jdr.state_from_heterograph(jhg0, incremental=incremental,
                                    nucleation_slack=slack)
    for k in FIELDS:
        a, b = getattr(ts, k), getattr(js, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert a.numpy().dtype == np.asarray(b).dtype, k
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=k)
    assert (ts.pull_cols is not None) == incremental
