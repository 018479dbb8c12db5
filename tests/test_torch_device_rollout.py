"""The port's device-resident span against the JAX package's, on the 120 um
bench graph with the shipped checkpoints and c_threshold 0.99: state setup
and sample construction equal (ELL tables bit-equal), then three spans,
each started from the SAME JAX state (no free-running comparison: a
reordered sum alone moves a chaotic multi-span trajectory)."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graingraphnn_torch.rollout import device_driver as dd
from graingraphnn_torch.rollout import device_rollout as dr
from graingraphnn_torch.train import checkpoint
from graingraphnn_tpu.data import extraction, heterograph
from graingraphnn_tpu.rollout import device_driver as jdd
from graingraphnn_tpu.rollout import device_rollout as jdr
from graingraphnn_tpu.train import checkpoint as jck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("xg", "xj", "E_pp", "E_pq", "mask_g", "mask_j", "n_pp")
INT_FIELDS = ("E_pp", "E_pq", "mask_g", "mask_j", "n_pp")
C_THRESHOLD = 0.99
POS_ATOL = 1e-5


def port_state(js):
    return dr.DeviceRolloutState(**{
        k: torch.from_numpy(np.array(getattr(js, k))) for k in FIELDS})


@pytest.fixture(scope="module")
def setup():
    traj = extraction.TrajectoryExtractor(
        lxd=120, seed=5, frames=121, bc="periodic",
        physical_params={"G": 1.904, "R": 0.558})
    traj.area_counts = dict(zip(*np.unique(traj.alpha_field,
                                           return_counts=True)))
    traj.area_traj.append(dict(traj.area_counts))
    traj.states.append(heterograph.tensorize(traj, 0))
    hg0 = extraction.make_test_sample(traj, span=6)
    js0, _, _ = jdd.init_scaled_state(hg0, traj)
    path = os.path.join(REPO, "artifacts", "40um")
    pr, hpr, _ = jck.load(os.path.join(path, "regressor0"))
    pc, hpc, _ = jck.load(os.path.join(path, "classifier1"))
    models = (checkpoint.params_from_jax(pr, hpr, "cpu"),
              checkpoint.params_from_jax(pc, hpc, "cpu"))
    step = jax.jit(lambda s: jdr.device_step(
        pr, hpr, pc, hpc, s, c_threshold=C_THRESHOLD, fused_editor=True))
    forward = jax.jit(lambda s: jdr.forward_stage(pr, hpr, pc, hpc, s, 16))
    return js0, models, step, forward


def test_init_scaled_state_matches_jax(setup):
    js0 = setup[0]
    x, edges, mask, lxd, patch = dd.load_fixture()
    ts, offset, factor = dd.init_scaled_state(x, edges, mask, lxd, patch,
                                              device="cpu")
    assert factor == 3.0 and offset.shape == (x["joint"].shape[0], 2)
    for k in FIELDS:
        a, b = getattr(ts, k).numpy(), np.asarray(getattr(js0, k))
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_make_sample_matches_jax(setup):
    js0 = setup[0]
    jsample, jover = jax.jit(jdr.make_sample)(js0)
    tsample, tover = dr.make_sample(port_state(js0))
    assert bool(tover) == bool(jover) is False
    for k in ("push_nbr", "push_mask", "connect_nbr", "connect_mask",
              "pull_nbr", "pull_mask", "jj_src", "jj_dst", "jj_mask"):
        np.testing.assert_array_equal(getattr(tsample, k).numpy(),
                                      np.asarray(getattr(jsample, k)),
                                      err_msg=k)
    for k in ("push_len", "connect_len", "pull_len", "jj_len"):
        np.testing.assert_allclose(getattr(tsample, k).numpy(),
                                   np.asarray(getattr(jsample, k)),
                                   rtol=0, atol=1e-7, err_msg=k)


@pytest.mark.parametrize("jax_fn", ["build_ell_sorted", "build_ell_rank",
                                     "build_ell_deg3"])
@pytest.mark.parametrize("max_deg", [3, 5])
def test_build_ell_bit_identical_to_jax(jax_fn, max_deg):
    """Random padded COO with dead sentinels and interleaved columns; the
    deg3 version only on degree <= 3 lists, where it is exact."""
    rng = np.random.default_rng(max_deg)
    num_dst, E = 41, 160
    dst = rng.integers(0, num_dst, E)
    if jax_fn == "build_ell_deg3":
        dst = np.repeat(np.arange(num_dst), 3)[rng.permutation(3 * num_dst)]
        E = len(dst)
    src = rng.integers(0, 57, E)
    dead = rng.uniform(size=E) < 0.25
    src[dead], dst[dead] = -1, -1
    attr = rng.uniform(0.1, 1.0, E).astype(np.float32)
    ref = getattr(jdr, jax_fn)(jnp.asarray(src, jnp.int32),
                                jnp.asarray(dst, jnp.int32),
                                jnp.asarray(attr), num_dst, max_deg)
    out = dr.build_ell(torch.tensor(src, dtype=torch.int32),
                       torch.tensor(dst, dtype=torch.int32),
                       torch.from_numpy(attr), num_dst, max_deg)
    for a, b in zip(out[:3], ref[:3]):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if jax_fn != "build_ell_deg3":
        assert bool(out[3]) == bool(ref[3])


def test_stages_match_jax(setup):
    js0 = setup[0]
    ts0 = port_state(js0)
    rng = np.random.default_rng(3)
    NG, NJ = ts0.xg.shape[0], ts0.xj.shape[0]
    pred_j = rng.uniform(-0.9, 0.9, (NJ, 2)).astype(np.float32)
    pred_g = rng.uniform(-0.9, 0.9, (NG, 2)).astype(np.float32)
    for z in (0.2, 0.99):                      # the z clamp off and on
        js = js0._replace(xg=js0.xg.at[:, 2].set(z))
        ts = port_state(js)
        jx = jdr.integrate_stage(js, jnp.asarray(pred_j), jnp.asarray(pred_g), 6)
        tx = dr.integrate_stage(ts, torch.from_numpy(pred_j),
                                torch.from_numpy(pred_g), 6)
        for a, b in zip(tx, jx):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    area = rng.uniform(-1e-4, 3e-4, NG).astype(np.float32)
    area[:40] = area[40]                       # ties keep index order
    jge, jn = jdr.elim_candidates(js0, jnp.asarray(area), 1e-4)
    tge, tn = dr.elim_candidates(ts0, torch.from_numpy(area), 1e-4)
    np.testing.assert_array_equal(tge.numpy(), np.asarray(jge))
    assert int(tn) == int(jn)
    E = np.array(js0.E_pp)
    E[:, rng.uniform(size=E.shape[1]) < 0.2] = -1
    jc = jdr.compact_stage(jnp.asarray(E))
    tc = dr.compact_stage(torch.from_numpy(E))
    np.testing.assert_array_equal(tc[0].numpy(), np.asarray(jc[0]))
    assert int(tc[1]) == int(jc[1])
    jxg = jdr.centers_stage(js0.xg, js0.xj, js0.E_pq, 16)
    txg = dr.centers_stage(ts0.xg, ts0.xj, ts0.E_pq, 16)
    np.testing.assert_allclose(txg.numpy(), np.asarray(jxg), rtol=0,
                               atol=POS_ATOL)


def assert_span_equal(ts, taux, js, jaux):
    for k in INT_FIELDS:
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)), err_msg=k)
    for k in ("xg", "xj"):
        np.testing.assert_allclose(getattr(ts, k).numpy(),
                                   np.asarray(getattr(js, k)), rtol=0,
                                   atol=POS_ATOL, err_msg=k)
    for k in ("grain_events", "extra_events", "switching", "message_edges",
              "ring_overflow", "pp_overflow", "elim_saturated"):
        np.testing.assert_array_equal(taux[k].numpy(), np.asarray(jaux[k]),
                                      err_msg=k)


def test_three_spans_match_jax_from_the_same_state(setup):
    """Each span starts from the JAX state. The whole port span must match,
    unless a switch probability lies within float noise of the threshold
    (then forward noise may rightly flip that event); the span after the
    forward, fed JAX's own forward outputs, must match in every case."""
    js, (reg, cls), step, forward = setup
    n_switch = n_elim = 0
    for _ in range(3):
        js_next, jaux = step(js)
        ts = port_state(js)
        t_next, taux = dr.device_step(reg, cls, ts, c_threshold=C_THRESHOLD)
        _, jy_r, jy_c, jover = forward(js)
        prob = np.asarray(jax.nn.sigmoid(jy_c["edge_event"]))
        near = bool((np.abs(prob - C_THRESHOLD) < 1e-5).any())
        try:
            assert_span_equal(t_next, taux, js_next, jaux)
        except AssertionError:
            if not near:
                raise
        to_t = lambda d: {k: torch.from_numpy(np.array(v))  # noqa: E731
                          for k, v in d.items()}
        p_next, paux = dr.post_forward_step(
            ts, to_t(jy_r), to_t(jy_c), torch.tensor(bool(jover)),
            torch.tensor(float(jaux["message_edges"])),
            c_threshold=C_THRESHOLD)
        assert_span_equal(p_next, paux, js_next, jaux)
        n_switch += int((np.asarray(jaux["switching"])[:, 0] >= 0).sum())
        n_elim += int((np.asarray(jaux["grain_events"]) >= 0).sum())
        js = js_next
    assert n_switch > 0 and n_elim > 0       # both editor phases ran


def test_make_rollout_stacks_aux_and_checks_capacity(setup):
    js0, (reg, cls), _, _ = setup
    run = dr.make_rollout(reg, cls, n_steps=2, c_threshold=C_THRESHOLD)
    st, aux = run(port_state(js0))
    assert aux["switching"].shape == (2, 24, 2)
    assert aux["message_edges"].shape == (2,)
    assert int(st.mask_g.sum()) <= int(js0.mask_g.sum())
    bad = {"ring_overflow": torch.tensor([False, True]),
           "pp_overflow": torch.tensor([False, False])}
    with pytest.raises(RuntimeError, match="ring_overflow at span 1"):
        dr.check_capacity(bad)


def test_entry_points_need_a_card_unless_asked_for_the_cpu():
    x, edges, mask, lxd, patch = dd.load_fixture()
    if torch.cuda.is_available():
        st, _, _ = dd.init_scaled_state(x, edges, mask, lxd, patch)
        assert st.xg.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dd.init_scaled_state(x, edges, mask, lxd, patch)


def test_deferred_options_raise(setup):
    """What the port still refuses: incremental ELL columns, and the
    driver's phase-field comparison, planar reconstruction and partitioned
    rollout."""
    _, (reg, cls), _, _ = setup
    x, edges, mask, lxd, patch = dd.load_fixture()
    with pytest.raises(NotImplementedError, match="incremental"):
        dr.init_device_state(x, edges, mask, incremental=True, device="cpu")
    traj = dd.load_trajectory()
    for kw, what in (({"compare": True}, "truth"),
                     ({"reconstruct": True}, "planar"),
                     ({"partition": 4}, "partitioned")):
        with pytest.raises(NotImplementedError, match=what):
            dd.run_device_resident(traj, reg, cls, device="cpu", **kw)
