"""The port's batched rollout (B independent lanes on one card) against the
JAX package's: stack_states, pack_states and the packed-space sample bit
for bit, then batched spans, each started from the SAME JAX state, against
make_rollout_scan_batched in its three packed_forward settings. Two 40 um
lanes of unequal size (seeds 5 and 7, as the JAX package's own batched
tests), the shipped checkpoints, c_threshold 0.9."""

import os

import jax
import numpy as np
import pytest
import torch

from graingraphnn_torch.rollout import device_rollout as dr
from graingraphnn_torch.rollout import topology_jit as tj
from graingraphnn_torch.train import checkpoint
from graingraphnn_tpu.data import extraction, heterograph
from graingraphnn_tpu.models import grain_nn as jgn
from graingraphnn_tpu.rollout import device_rollout as jdr
from graingraphnn_tpu.train import checkpoint as jck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("xg", "xj", "E_pp", "E_pq", "mask_g", "mask_j", "n_pp")
INT_FIELDS = ("E_pp", "E_pq", "mask_g", "mask_j", "n_pp")
COLS = ("pull_cols", "push_cols", "connect_cols")
C_THRESHOLD = 0.9
POS_ATOL = 1e-5        # one span from the same state
LANE_ATOL = 2e-5       # a lane against its single-lane run (JAX's bound)
SAMPLE_FIELDS = ("push_nbr", "push_mask", "connect_nbr", "connect_mask",
                 "pull_nbr", "pull_mask", "jj_src", "jj_dst", "jj_mask",
                 "grain_x", "joint_x", "grain_mask", "joint_mask")
LEN_FIELDS = ("push_len", "connect_len", "pull_len", "jj_len")
ID_MASKS = {"push_nbr": "push_mask", "connect_nbr": "connect_mask",
            "pull_nbr": "pull_mask", "jj_src": "jj_mask", "jj_dst": "jj_mask"}


def _hg(seed):
    traj = extraction.TrajectoryExtractor(
        lxd=40, seed=seed, frames=121, bc="periodic",
        physical_params={"G": 4.0, "R": 1.0})
    traj.area_counts = dict(zip(*np.unique(traj.alpha_field,
                                           return_counts=True)))
    traj.area_traj.append(dict(traj.area_counts))
    traj.states.append(heterograph.tensorize(traj, 0))
    return extraction.make_test_sample(traj, span=6)


def port_state(js, fields=FIELDS):
    return dr.DeviceRolloutState(**{
        k: torch.from_numpy(np.array(getattr(js, k))) for k in fields
        if getattr(js, k) is not None})


@pytest.fixture(scope="module")
def setup():
    hgs = [_hg(5), _hg(7)]
    path = os.path.join(REPO, "artifacts", "40um")
    pr, hpr, _ = jck.load(os.path.join(path, "regressor0"))
    pc, hpc, _ = jck.load(os.path.join(path, "classifier1"))
    models = (checkpoint.params_from_jax(pr, hpr, "cpu"),
              checkpoint.params_from_jax(pc, hpc, "cpu"))
    singles = {inc: [jdr.state_from_heterograph(h, incremental=inc)
                     for h in hgs] for inc in (False, True)}
    assert singles[False][0].xg.shape != singles[False][1].xg.shape
    return singles, (pr, hpr, pc, hpc), models


def _assert_state_equal(t, j, fields):
    for k in fields:
        a, b = getattr(t, k), getattr(j, k)
        assert (a is None) == (b is None), k
        if a is not None:
            assert a.numpy().dtype == np.asarray(b).dtype, k
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=k)


@pytest.mark.parametrize("incremental", [False, True])
def test_stack_and_pack_states_match_jax(setup, incremental):
    singles = setup[0][incremental]
    fields = FIELDS + (COLS if incremental else ())
    ports = [port_state(s, fields) for s in singles]
    _assert_state_equal(dr.stack_states(ports), jdr.stack_states(singles),
                        FIELDS + COLS)
    _assert_state_equal(dr.pack_states(ports), jdr.pack_states(singles),
                        FIELDS + COLS)


def test_pack_build_sample_matches_jax(setup):
    """The packed-space sample bit-equal to JAX's `_pack_build_sample` and
    to its hybrid form, `_pack_sample_rows` of the vmapped make_sample;
    edge lengths within 1e-7. The hybrid form offsets a dead slot's 0 fill
    by its lane like a live id, so its node ids are held on live slots."""
    jb = jdr.stack_states(setup[0][False])
    tsample, tflags, tedges = dr._pack_build_sample(port_state(jb))
    tover = tflags["ring_overflow"]
    assert not (bool(tflags["jg_overflow"]) or bool(tflags["jj_overflow"]))
    jsample, jover, jedges = jax.jit(
        lambda s: jdr._pack_build_sample(s, 16))(jb)
    jrows, jover_v = jax.jit(lambda s: jax.vmap(jdr.make_sample)(s))(jb)
    jrows = jdr._pack_sample_rows(jrows)
    np.testing.assert_array_equal(tover.numpy(), np.asarray(jover))
    np.testing.assert_array_equal(tover.numpy(), np.asarray(jover_v))
    np.testing.assert_array_equal(tedges.numpy(), np.asarray(jedges))
    for ref in (jsample, jrows):
        for k in SAMPLE_FIELDS:
            out = getattr(tsample, k).numpy()
            want = np.asarray(getattr(ref, k))
            if ref is jrows and k in ID_MASKS:
                live = getattr(tsample, ID_MASKS[k]).numpy() > 0
                out, want = out[live], want[live]
            np.testing.assert_array_equal(out, want, err_msg=k)
        for k in LEN_FIELDS:
            np.testing.assert_allclose(getattr(tsample, k).numpy(),
                                       np.asarray(getattr(ref, k)), rtol=0,
                                       atol=1e-7, err_msg=k)


def _near_threshold(logits):
    p = np.asarray(jax.nn.sigmoid(logits))
    return bool((np.abs(p - C_THRESHOLD) < 1e-5).any())


@pytest.mark.parametrize("packed_forward", [False, True, "full"])
def test_batched_span_matches_jax(setup, packed_forward):
    """Four batched spans, each from the JAX state (the last two eliminate
    at the full budget in both lanes): topology and aux
    bit-equal unless a switch probability lies within 1e-5 of the
    threshold (ROADMAP Queue 3, the sigmoid ulp), positions within 1e-5.
    JAX's three settings compute one function up to fp row blocking; the
    port has one path, held against each."""
    singles, (pr, hpr, pc, hpc), (reg, cls) = setup
    jrun = jdr.make_rollout_scan_batched(
        pr, hpr, pc, hpc, n_steps=1, c_threshold=C_THRESHOLD,
        fused_editor=True, packed_forward=packed_forward)
    forward = jax.jit(lambda s: jdr._pack_build_sample(s, 16)[0])
    classify = jax.jit(lambda smp: jgn.apply_classifier(
        pc, hpc, smp)["edge_event"])
    js = jdr.stack_states(singles[False])
    n_switch = n_elim = 0
    for _ in range(4):
        js_next, jaux = jrun(js)
        t_next, taux = dr.batched_step(reg, cls, port_state(js),
                                       c_threshold=C_THRESHOLD)
        near = _near_threshold(classify(forward(js)))
        try:
            for k in INT_FIELDS:
                np.testing.assert_array_equal(
                    getattr(t_next, k).numpy(),
                    np.asarray(getattr(js_next, k)), err_msg=k)
            for k in ("grain_events", "extra_events", "switching",
                      "message_edges", "ring_overflow", "pp_overflow",
                      "elim_saturated"):
                np.testing.assert_array_equal(taux[k].numpy(),
                                              np.asarray(jaux[k])[0],
                                              err_msg=k)
        except AssertionError:
            if not near:
                raise
        for k in ("xg", "xj"):
            np.testing.assert_allclose(getattr(t_next, k).numpy(),
                                       np.asarray(getattr(js_next, k)),
                                       rtol=0, atol=POS_ATOL, err_msg=k)
        n_switch += int((np.asarray(jaux["switching"])[..., 0] >= 0).sum())
        n_elim += int((np.asarray(jaux["grain_events"]) >= 0).sum())
        js = js_next
    assert n_switch > 0 and n_elim > 0


def _single_runs(singles, reg, cls, n_steps, fields=FIELDS, **kw):
    run = dr.make_rollout(reg, cls, n_steps=n_steps,
                          c_threshold=C_THRESHOLD, **kw)
    return [run(port_state(s, fields))[0] for s in singles]


def _assert_lane(t, i, s, cols=()):
    """Lane i of a stacked state against its single-lane state s: rows
    and columns past the lane's own are padding."""
    ng, nj = s.xg.shape[0], s.xj.shape[0]
    ep, eq = s.E_pp.shape[1], s.E_pq.shape[1]
    np.testing.assert_allclose(t.xg[i, :ng].numpy(), s.xg.numpy(), rtol=0,
                               atol=LANE_ATOL)
    np.testing.assert_allclose(t.xj[i, :nj].numpy(), s.xj.numpy(), rtol=0,
                               atol=LANE_ATOL)
    for k, n in (("mask_g", ng), ("mask_j", nj)):
        np.testing.assert_array_equal(getattr(t, k)[i, :n].numpy(),
                                      getattr(s, k).numpy(), err_msg=k)
        assert not getattr(t, k)[i, n:].any(), k
    for k, n in (("E_pp", ep), ("E_pq", eq)):
        np.testing.assert_array_equal(getattr(t, k)[i, :, :n].numpy(),
                                      getattr(s, k).numpy(), err_msg=k)
        assert bool((getattr(t, k)[i, :, n:] == -1).all()), k
    assert int(t.n_pp[i]) == int(s.n_pp)
    for k in cols:
        n = getattr(s, k).shape[0]
        np.testing.assert_array_equal(getattr(t, k)[i, :n].numpy(),
                                      getattr(s, k).numpy(), err_msg=k)


def test_batched_run_matches_single_lanes(setup):
    """Each lane of a 3-span batched run against the port's single-lane
    make_rollout of that lane, and the aux's [n_steps, B] layout."""
    singles, _, (reg, cls) = setup
    stacked = dr.stack_states([port_state(s) for s in singles[False]])
    out, aux = dr.make_rollout_batched(reg, cls, n_steps=3,
                                       c_threshold=C_THRESHOLD)(stacked)
    assert aux["switching"].shape == (3, 2, tj.MAX_SWITCH, 2)
    assert aux["grain_events"].shape == (3, 2, tj.MAX_ELIM)
    assert aux["message_edges"].shape == aux["ring_overflow"].shape == (3, 2)
    assert int((aux["switching"][..., 0] >= 0).sum()) > 0
    for i, s in enumerate(_single_runs(singles[False], reg, cls, 3)):
        _assert_lane(out, i, s)


def test_packed_path_matches_single_lanes(setup):
    """pack_states on the single-lane make_rollout with the budgets x B
    advances each lane as its single run does (JAX's
    test_packed_scan_matches_single_rollouts). In these three spans no
    lane has more switch or elimination candidates than its own budget;
    where one does, the packed run shares the budget out otherwise."""
    singles, _, (reg, cls) = setup
    B = len(singles[False])
    packed = dr.pack_states([port_state(s) for s in singles[False]])
    out, aux = dr.make_rollout(
        reg, cls, n_steps=3, c_threshold=C_THRESHOLD,
        max_elim=tj.MAX_ELIM * B, max_switch=tj.MAX_SWITCH * B)(packed)
    assert not bool(aux["ring_overflow"].any() or aux["pp_overflow"].any())
    g0 = j0 = 0
    for s in _single_runs(singles[False], reg, cls, 3):
        ng, nj = s.xg.shape[0], s.xj.shape[0]
        np.testing.assert_allclose(out.xg[g0:g0 + ng].numpy(), s.xg.numpy(),
                                   rtol=0, atol=LANE_ATOL)
        np.testing.assert_array_equal(out.mask_g[g0:g0 + ng].numpy(),
                                      s.mask_g.numpy())
        np.testing.assert_array_equal(out.mask_j[j0:j0 + nj].numpy(),
                                      s.mask_j.numpy())
        # the lane's live jj edges, in order, are its single run's
        lane = (out.E_pp[0] >= j0) & (out.E_pp[0] < j0 + nj)
        np.testing.assert_array_equal(
            (out.E_pp[:, lane] - j0).numpy(),
            s.E_pp[:, s.E_pp[0] >= 0].numpy())
        g0, j0 = g0 + ng, j0 + nj


@pytest.mark.parametrize("touch_max", [dr.TOUCH_MAX, 2])
def test_batched_run_with_column_tables(setup, monkeypatch, touch_max):
    """Lanes carrying column tables (incremental=True) stay lane-exact
    against single-lane runs on the tables, the tables included (JAX's
    test_batched_scan_with_incremental_structures); with a touch budget
    of 2 a lane takes the tables' fallback rebuild."""
    singles, _, (reg, cls) = setup
    monkeypatch.setattr(dr, "TOUCH_MAX", touch_max)
    busts = []
    update = dr.update_ell_cols
    monkeypatch.setattr(dr, "update_ell_cols", lambda *a, **k: (
        lambda out: (busts.append(bool(out[1].any())), out)[1])(
            update(*a, **k)))
    fields = FIELDS + COLS
    stacked = dr.stack_states([port_state(s, fields)
                               for s in singles[True]])
    assert stacked.pull_cols is not None
    out, _ = dr.make_rollout_batched(reg, cls, n_steps=2,
                                     c_threshold=C_THRESHOLD)(stacked)
    assert any(busts) == (touch_max == 2)
    for i, s in enumerate(_single_runs(singles[True], reg, cls, 2,
                                       fields=fields)):
        _assert_lane(out, i, s, cols=COLS)


def test_check_capacity_names_span_and_lane():
    ok = torch.zeros((3, 4), dtype=torch.bool)
    bad = ok.clone()
    bad[2, 1] = bad[2, 3] = True
    with pytest.raises(RuntimeError, match="pp_overflow at span 2, lane 1"):
        dr.check_capacity({"ring_overflow": ok, "pp_overflow": bad,
                           "nuc_overflow": ok})
    dr.check_capacity({"ring_overflow": ok, "pp_overflow": ok,
                       "nuc_overflow": ok})


def test_batched_span_refuses_the_melt_pool_and_nucleation(setup):
    singles, _, (reg, cls) = setup
    stacked = dr.stack_states([port_state(s) for s in singles[False]])
    y_r = {"joint": torch.zeros(stacked.xj.shape[:2] + (2,)),
           "grain": torch.zeros(stacked.xg.shape[:2] + (2,)),
           "grain_area": torch.ones(stacked.xg.shape[:2])}
    y_c = {"edge_event": torch.zeros(stacked.E_pp.shape[0],
                                     stacked.E_pp.shape[2])}
    with pytest.raises(ValueError, match="static spans only"):
        dr.post_forward_step(stacked, y_r, y_c, torch.zeros(2, dtype=bool),
                             torch.zeros(2), nuc_density_term=1.0)
