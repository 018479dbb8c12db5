"""The port's phase-field (PF) extraction against the JAX package's, on
the synthetic PF files of chip_smoke (the host engine's truth at the 40 um
recipe, 13 frames here, written with h5py), periodic and no-flux:

- train mode: every state's feature, edge-weight and target dicts within
  atol 1e-12, edge indices and masks equal; the events, save_frame, areas
  and volumes equal; calibrate_span and make_training_samples too;
- test mode: the t=0 sample, the same way;
- a frame made short of one junction is quarantined in both;
- under no-flux a grain of a few pixels keeps one junction, and both
  packages' tensorize raise the same KeyError at the same frame;
- check_connectivity, _quadruple_keys and repair_with_quadruples on
  junction dicts drawn with hypothesis, equal with their order.
"""

import copy
import itertools

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from graingraphnn_torch.data import extraction as tx
from graingraphnn_tpu.data import extraction as jx

FRAMES = 13
ATOL = 1e-12


@pytest.fixture(scope="module")
def truths():
    return {bc: chip_smoke.pf_truth(bc) for bc in ("periodic", "noflux")}


@pytest.fixture(scope="module")
def pf_dirs(truths, tmp_path_factory):
    """One 13-frame synthetic PF file per boundary, each in its own
    directory."""
    out = {}
    for bc, truth in truths.items():
        d = tmp_path_factory.mktemp(bc)
        chip_smoke.write_pf_file(d, chip_smoke.synthetic_pf_arrays(
            FRAMES, bc, truth))
        out[bc] = str(d)
    return out


def extract_both(rawdat, bc="periodic", match_graph=True, cache=None):
    out = []
    for mod in (jx, tx):
        traj = mod.TrajectoryExtractor(lxd=40, seed=10020, frames=FRAMES,
                                       bc=bc)
        traj.match_graph = match_graph
        traj.extract(rawdat, cache_dir=str(cache))
        out.append(traj)
    return out


def same_dict(a, b, exact=False):
    assert a.keys() == b.keys()
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.shape == y.shape, k
        if exact:
            np.testing.assert_array_equal(x, y, err_msg=str(k))
        else:
            np.testing.assert_allclose(x, y, rtol=0, atol=ATOL,
                                       err_msg=str(k))


def same_state(j, t):
    same_dict(j.feature_dicts, t.feature_dicts)
    same_dict(j.edge_weight_dicts, t.edge_weight_dicts)
    same_dict(j.target_dicts, t.target_dicts)
    same_dict(j.edge_index_dicts, t.edge_index_dicts, exact=True)
    same_dict(j.mask, t.mask, exact=True)
    assert j.edges == t.edges and j.vertex2joint == t.vertex2joint
    assert j.physical_params == t.physical_params and j.span == t.span


def same_trajectory(j, t):
    for k in ("edge_events", "grain_events", "save_frame", "area_traj"):
        assert getattr(j, k) == getattr(t, k), k
    for k in ("extraV_frames", "totalV_frames", "alpha_pde_frames"):
        np.testing.assert_array_equal(getattr(j, k), getattr(t, k), k)
    assert j.joint2vertex == t.joint2vertex and j.vertices == t.vertices
    assert j.physical_params == t.physical_params
    assert len(j.states) == len(t.states)
    for a, b in zip(j.states, t.states):
        same_state(a, b)


def test_train_mode_matches_jax(pf_dirs, tmp_path):
    """Train mode on the periodic file: the whole trajectory, then the
    calibrated span and the training windows (with one history column
    and stride 1 as well as the defaults)."""
    j, t = extract_both(pf_dirs["periodic"], cache=tmp_path)
    same_trajectory(j, t)
    assert t.save_frame.count(False) < FRAMES - 2
    assert len(set.union(*t.edge_events)) > 0
    assert len(set.union(*t.grain_events)) > 0
    span = tx.calibrate_span(t)
    assert span == jx.calibrate_span(j)
    for kw in (dict(span=span), dict(span=span, prev=1, stride=1)):
        jj, tt = (copy.deepcopy(x) for x in (j, t))
        js = jx.make_training_samples(jj, **kw)
        ts = tx.make_training_samples(tt, **kw)
        assert len(ts) == len(js) > 0
        for a, b in zip(js, ts):
            same_state(a, b)


def test_the_repairs_are_exercised(pf_dirs, tmp_path, monkeypatch):
    """The periodic file's frames reach repair_with_quadruples with
    quadruple candidates, and some repair inserts a junction."""
    calls = []
    orig = tx.repair_with_quadruples

    def repair(quadruples, total_missing, cur_joint, miss_case, del_joints):
        n = len(cur_joint)
        orig(quadruples, total_missing, cur_joint, miss_case, del_joints)
        calls.append((len(quadruples), len(cur_joint) - n))

    monkeypatch.setattr(tx, "repair_with_quadruples", repair)
    traj = tx.TrajectoryExtractor(lxd=40, seed=10020, frames=FRAMES)
    traj.extract(pf_dirs["periodic"], cache_dir=str(tmp_path))
    assert any(q > 0 and added > 0 for q, added in calls)


@pytest.mark.parametrize("bc", ["periodic", "noflux"])
def test_test_mode_matches_jax(pf_dirs, tmp_path, bc):
    """Test mode (frame 0 matched, the others' areas and eliminations
    only) and the t=0 sample."""
    j, t = extract_both(pf_dirs[bc], bc=bc, match_graph=False, cache=tmp_path)
    same_trajectory(j, t)
    assert len(t.states) == 1 and len(t.grain_events) == FRAMES
    same_state(jx.make_test_sample(j, span=6), tx.make_test_sample(t, span=6))


def test_noflux_train_mode_raises_as_in_jax(pf_dirs, tmp_path):
    """Under no-flux no frame is quarantined, so a grain shrunk to a few
    pixels that keeps one junction reaches tensorize without a region:
    both packages raise the same KeyError at the same frame, with equal
    states before it."""
    trajs, errors = [], []
    for mod in (jx, tx):
        traj = mod.TrajectoryExtractor(lxd=40, seed=10020, frames=FRAMES,
                                       bc="noflux")
        with pytest.raises(KeyError) as err:
            traj.extract(pf_dirs["noflux"], cache_dir=str(tmp_path))
        trajs.append(traj)
        errors.append(err.value.args)
    j, t = trajs
    assert errors[0] == errors[1]
    assert 1 < len(t.states) == len(j.states) < FRAMES
    for a, b in zip(j.states, t.states):
        same_state(a, b)
    assert j.edge_events == t.edge_events and j.grain_events == t.grain_events


def test_a_frame_short_of_a_junction_is_quarantined(truths, tmp_path):
    """Frame 1 with every candidate of one junction triple dropped from
    node_region: both packages quarantine it (save_frame False, no
    events) and go on alike."""
    arrays, G, R, frames = chip_smoke.synthetic_pf_arrays(
        FRAMES, "periodic", truths["periodic"])
    nr = arrays["node_region"].reshape((8, -1, frames), order="F").copy()
    labels = nr[3:, :, 1]
    keys = [tuple(sorted(set(labels[:, v]) - {-1})) for v in
            range(labels.shape[1])]
    triple = next(k for k in keys if len(k) == 3)
    nr[3:, [v for v, k in enumerate(keys) if k == triple], 1] = -1
    arrays = dict(arrays, node_region=nr.ravel(order="F"))
    chip_smoke.write_pf_file(tmp_path, (arrays, G, R, frames))
    j, t = extract_both(str(tmp_path), cache=tmp_path / "cache")
    same_trajectory(j, t)
    assert t.save_frame[1] is False and t.edge_events[1] == set()


def test_load_pf_arrays_checks_the_domain(truths):
    """The PF arrays must be of the extractor's domain and raster."""
    arrays, G, R, frames = chip_smoke.synthetic_pf_arrays(
        FRAMES, "periodic", truths["periodic"])
    traj = tx.TrajectoryExtractor(lxd=40, seed=10020, frames=FRAMES)
    bad = dict(arrays, x_coordinates=arrays["x_coordinates"] * 2)
    with pytest.raises(ValueError, match="um"):
        traj.load_pf_arrays(bad, G, R, frames)
    bad = dict(arrays, x_coordinates=arrays["x_coordinates"][1:])
    with pytest.raises(ValueError, match="raster"):
        traj.load_pf_arrays(bad, G, R, frames)


# ---------------------------------------------------------------------------
# the repair helpers on drawn junction dicts
# ---------------------------------------------------------------------------

GRAINS = list(range(1, 9))
TRIPLES = list(itertools.combinations(GRAINS, 3))
QUADS = list(itertools.combinations(GRAINS, 4))
coords = st.lists(st.floats(0, 1, allow_nan=False), min_size=3, max_size=3)


@st.composite
def junction_dicts(draw, pool=TRIPLES, max_size=24):
    keys = draw(st.lists(st.sampled_from(pool), max_size=max_size,
                         unique=True))
    return {k: draw(coords) for k in keys}


@settings(max_examples=60, deadline=None)
@given(junction_dicts(pool=TRIPLES + [(1, 2), (3,), (2, 5)]))
def test_check_connectivity_matches_jax(cur_joint):
    a = jx.check_connectivity(cur_joint)
    b = tx.check_connectivity(cur_joint)
    assert a[0] == b[0] and a[1] == b[1]
    assert list(a[2].items()) == list(b[2].items())


@settings(max_examples=60, deadline=None)
@given(st.lists(st.sampled_from(TRIPLES), max_size=16, unique=True))
def test_quadruple_keys_match_jax(junctions):
    a, b = jx._quadruple_keys(junctions), tx._quadruple_keys(junctions)
    assert list(a.items()) == list(b.items())


@settings(max_examples=60, deadline=None)
@given(junction_dicts(), junction_dicts(pool=QUADS, max_size=4),
       junction_dicts(max_size=4))
def test_repair_with_quadruples_matches_jax(cur_joint, quadruples, deleted):
    out = []
    for mod in (jx, tx):
        joints = copy.deepcopy(cur_joint)
        total, _, miss = mod.check_connectivity(joints)
        mod.repair_with_quadruples(quadruples, total, joints, miss,
                                   copy.deepcopy(deleted))
        out.append(list(joints.items()))
    assert out[0] == out[1]
