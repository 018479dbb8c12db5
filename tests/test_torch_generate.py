"""The port's generate-mode span pieces against the JAX package's, on the
120 um bench graph with nucleation slack and the shipped checkpoints: the
nucleation pass (same numpy draws), the moving melt pool's window, and
three windowed, nucleating spans, each started from the SAME JAX state."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graingraphnn_torch.rollout import device_driver as dd
from graingraphnn_torch.rollout import device_rollout as dr
from graingraphnn_torch.rollout import topology_jit as ttj
from graingraphnn_torch.train import checkpoint
from graingraphnn_tpu.rollout import device_driver as jdd
from graingraphnn_tpu.rollout import device_rollout as jdr
from graingraphnn_tpu.rollout import topology_jit as jtj
from graingraphnn_tpu.train import checkpoint as jck
from tests.test_torch_device_rollout import C_THRESHOLD, POS_ATOL, REPO
from tests.test_torch_fixture import jax_start

SLACK = 16
FIELDS = ("xg", "xj", "E_pp", "E_pq", "mask_g", "mask_j", "n_pp", "n_g",
          "n_j", "n_pq")
INTS = ("E_pp", "E_pq", "mask_g", "mask_j", "n_pp", "n_g", "n_j", "n_pq")
MELTPOOL = {"r0": 20.0, "z0": 4.0, "melt_pool_angle": math.pi / 4}


def port_state(js):
    return dr.DeviceRolloutState(**{
        k: torch.from_numpy(np.array(getattr(js, k))) for k in FIELDS})


def t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def setup():
    traj, hg0 = jax_start()
    js0, offset_j, factor = jdd.init_scaled_state(hg0, traj,
                                                  nucleation_slack=SLACK)
    tmt, gap = dd.make_melt_term(MELTPOOL, traj.lxd, 6, js0.xj.shape[0],
                                 offset_j, factor, "cpu")
    jmt = dict(tmt, offset_x=jnp.asarray(tmt["offset_x"].numpy()))
    return js0, jmt, tmt, gap


def test_nucleation_state_matches_jax(setup):
    """init_device_state pads rows and columns and seeds the cursors as
    the JAX package does."""
    js0 = setup[0]
    traj = dd.load_trajectory()
    ts, _, _ = dd.init_scaled_state(traj.x, traj.edges, traj.mask, traj.lxd,
                                    traj.patch_size, nucleation_slack=SLACK,
                                    device="cpu")
    for k in FIELDS:
        a, b = getattr(ts, k).numpy(), np.asarray(getattr(js0, k))
        assert a.dtype == b.dtype, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def nucleation_case(js0, case):
    """(TopoState of js0 with q_ptr, rand [NJcap], angles, prob, expected
    nucleations) of one scenario."""
    rng = np.random.default_rng(len(case))
    NJ = js0.xj.shape[0]
    live = np.nonzero(np.asarray(js0.mask_j) > 0)[0]
    E_pq = np.array(js0.E_pq)
    rand = np.ones(NJ, np.float32)
    prob, want = np.float32(0.5), 2
    if case == "two_sites":
        rand[rng.choice(live, 2, replace=False)] = 0.0
    elif case == "beyond_max_nuc":
        rand[rng.choice(live, 7, replace=False)] = 0.25
        want = ttj.MAX_NUC
    elif case == "no_op_site":
        # the first site's junction loses a jg edge: it has 2 grain
        # neighbours, so it is consumed and changes nothing
        sites = np.sort(rng.choice(live, 2, replace=False))
        rand[sites] = 0.0
        E_pq[:, np.nonzero(E_pq[0] == sites[0])[0][0]] = -1
        want = 1
    elif case == "pad_rows":
        # realistic draws, pad rows at >= 1 as the driver's contract says
        rand = rng.random(NJ).astype(np.float32)
        rand[live.max() + 1:] = 1.5
        prob = np.float32(4e-3)
        want = int(min(ttj.MAX_NUC, (rand < prob).sum()))
    angles = rng.random((ttj.MAX_NUC, 2)).astype(np.float32)
    return E_pq, rand, angles, prob, want


@pytest.mark.parametrize("case", ["two_sites", "beyond_max_nuc",
                                  "no_op_site", "pad_rows"])
def test_nucleate_jit_matches_jax(setup, case):
    js0 = setup[0]
    E_pq, rand, angles, prob, want = nucleation_case(js0, case)
    NJ = js0.xj.shape[0]
    y_joint = np.random.default_rng(1).uniform(-0.5, 0.5, (NJ, 2)).astype(
        np.float32)
    jst = jtj.TopoState(
        E_pp=js0.E_pp, E_pq=jnp.asarray(E_pq), xj=js0.xj,
        y_joint=jnp.asarray(y_joint), mask_g=js0.mask_g, mask_j=js0.mask_j,
        append_ptr=js0.n_pp, q_ptr=js0.n_pq)
    ref = jtj.nucleate_jit(jst, js0.xg, js0.n_g, js0.n_j, jnp.asarray(rand),
                           jnp.asarray(angles), prob)
    tst = ttj.TopoState(
        E_pp=t(js0.E_pp), E_pq=t(E_pq), xj=t(js0.xj), y_joint=t(y_joint),
        mask_g=t(js0.mask_g), mask_j=t(js0.mask_j), append_ptr=t(js0.n_pp),
        q_ptr=t(js0.n_pq))
    out = ttj.nucleate_jit(tst, t(js0.xg), t(js0.n_g), t(js0.n_j), t(rand),
                           t(angles), torch.tensor(prob))
    (s1, xg1, g1, j1, n1), (s2, xg2, g2, j2, n2) = ref, out
    assert int(n1) == int(n2) == want
    for f in ("E_pp", "E_pq", "mask_g", "mask_j", "append_ptr", "q_ptr"):
        np.testing.assert_array_equal(getattr(s2, f).numpy(),
                                      np.asarray(getattr(s1, f)), err_msg=f)
    assert (int(g2), int(j2)) == (int(g1), int(j1))
    assert int(g2) == int(js0.n_g) + want and int(j2) == int(js0.n_j) + 2 * want
    np.testing.assert_allclose(xg2.numpy(), np.asarray(xg1), rtol=0, atol=1e-6)
    np.testing.assert_allclose(s2.xj.numpy(), np.asarray(s1.xj), rtol=0,
                               atol=1e-6)


def window_f64(x, ml, mt):
    """melt_stage's taper in float64, to find values near the threshold."""
    mr, me = ml + mt["win"], ml + mt["win"] + mt["gap"]
    near = np.clip((x - me) / (mr - me), 0.0, 1.0)
    return np.where(x < ml, 0.0, near)


@pytest.mark.parametrize("span", [0, 30, 62])
def test_melt_stage_matches_jax(setup, span):
    """Three window positions, from the sweep's start to past the middle:
    predictions within 1e-6, windows equal except within 1e-6 of the
    0.9999 cut."""
    js0, jmt, tmt, gap = setup
    rng = np.random.default_rng(span)
    NG, NJ = js0.xg.shape[0], js0.xj.shape[0]
    pred_j = rng.uniform(-0.9, 0.9, (NJ, 2)).astype(np.float32)
    pred_g = rng.uniform(-0.9, 0.9, (NG, 2)).astype(np.float32)
    ml = np.float32(span * gap)
    ref = jdr.melt_stage(js0, jnp.asarray(pred_j), jnp.asarray(pred_g), jmt,
                         jnp.float32(ml))
    out = dr.melt_stage(port_state(js0), t(pred_j), t(pred_g), tmt,
                        torch.tensor(ml))
    for a, b in zip(out[:2], ref[:2]):
        b = np.asarray(b)
        assert np.isfinite(b).all()
        np.testing.assert_allclose(a.numpy(), b, rtol=0, atol=1e-6)
    xj = np.asarray(js0.xj, np.float64)[:, 0] + np.asarray(jmt["offset_x"])
    aw = {"g": window_f64(np.asarray(js0.xg, np.float64)[:, 0] / 3.0, ml, tmt),
          "j": window_f64(xj / 3.0, ml, tmt)}
    for a, b, k in ((out[2], ref[2], "g"), (out[3], ref[3], "j")):
        differ = a.numpy() != np.asarray(b)
        assert (np.abs(aw[k][differ] - 0.9999) < 1e-6).all()
    assert out[3].any() and not out[3].all()     # the window gates joints
    # grains are placed by their patch-local x / 3, so once the window has
    # passed x = 1/3 no grain is in it
    assert bool(out[2].any()) == (ml < 1 / 3)


def test_melt_stage_stays_finite_where_jax_divides_zero_by_zero(setup):
    """A grain behind the window exactly where the curvature line crosses
    zero: the JAX package's taper gives 0 * r0 / 0 = NaN there, the port's
    gives 0; every other value is the same."""
    js0, jmt, tmt, gap = setup
    ml = np.float32(9 * gap)
    xg = np.array(js0.xg)
    xg[0, 0] = 0.17          # a grain of the fixture sits here at span 9
    js = js0._replace(xg=jnp.asarray(xg))
    NG, NJ = xg.shape[0], js0.xj.shape[0]
    ones_j = np.ones((NJ, 2), np.float32)
    ones_g = np.ones((NG, 2), np.float32)
    ref = jdr.melt_stage(js, jnp.asarray(ones_j), jnp.asarray(ones_g), jmt,
                         jnp.float32(ml))
    out = dr.melt_stage(port_state(js), t(ones_j), t(ones_g), tmt,
                        torch.tensor(ml))
    assert np.isnan(np.asarray(ref[1])[0, 0]) and out[1][0, 0].item() == 0.0
    for a, b in zip(out[:2], ref[:2]):
        b = np.asarray(b)
        assert torch.isfinite(a).all()
        ok = np.isfinite(b)
        np.testing.assert_array_equal(a.numpy()[ok], b[ok])
        assert (a.numpy()[~ok] == 0).all()


@pytest.fixture(scope="module")
def models():
    path = REPO + "/artifacts/40um/"
    pr, hpr, _ = jck.load(path + "regressor0")
    pc, hpc, _ = jck.load(path + "classifier1")
    return (pr, hpr, pc, hpc), (checkpoint.params_from_jax(pr, hpr, "cpu"),
                                checkpoint.params_from_jax(pc, hpc, "cpu"))


def test_three_windowed_nucleating_spans_match_jax(setup, models):
    """Spans with the moving melt pool mid-sweep and two forced nucleation
    sites each. The whole port span must match JAX's (fused editor), unless
    a switch probability lies within 1e-5 of the threshold; the span after
    the forward, fed JAX's forward outputs, must match in every case.
    Cursors and the nucleation overflow flag included."""
    js, jmt, tmt, gap = setup
    (pr, hpr, pc, hpc), (reg, cls) = models
    density_term = 1.0       # the sites come from the forced draws
    kw = dict(c_threshold=C_THRESHOLD, nuc_density_term=density_term)
    step = jax.jit(lambda s, r, a, ml: jdr.device_step(
        pr, hpr, pc, hpc, s, fused_editor=True, nuc_rand=r, nuc_angles=a,
        melt_term=jmt, melt_left=ml, **kw))
    forward = jax.jit(lambda s: jdr.forward_stage(pr, hpr, pc, hpc, s, 16))
    rng = np.random.default_rng(7)
    n_gated = 0
    for span in (24, 25, 26):
        NJ = js.xj.shape[0]
        live = np.nonzero(np.asarray(js.mask_j) > 0)[0]
        rand = np.ones(NJ, np.float32)
        rand[rng.choice(live, 2, replace=False)] = 0.0
        angles = rng.random((ttj.MAX_NUC, 2)).astype(np.float32)
        ml = np.float32(span * gap)
        js_next, jaux = step(js, jnp.asarray(rand), jnp.asarray(angles),
                             jnp.float32(ml))
        assert int(js_next.n_g) == int(js.n_g) + 2
        ts = port_state(js)
        tkw = dict(kw, nuc_rand=t(rand), nuc_angles=t(angles),
                   melt_term=tmt, melt_left=torch.tensor(ml))
        t_next, taux = dr.device_step(reg, cls, ts, **tkw)
        _, jy_r, jy_c, jover = forward(js)
        prob = np.asarray(jax.nn.sigmoid(jy_c["edge_event"]))
        near = bool((np.abs(prob - C_THRESHOLD) < 1e-5).any())
        try:
            assert_span_equal(t_next, taux, js_next, jaux)
        except AssertionError:
            if not near:
                raise
        to_t = lambda d: {k: t(v) for k, v in d.items()}  # noqa: E731
        p_next, paux = dr.post_forward_step(
            ts, to_t(jy_r), to_t(jy_c), torch.tensor(bool(jover)),
            torch.tensor(float(jaux["message_edges"])), **tkw)
        assert_span_equal(p_next, paux, js_next, jaux)
        _, _, active_g, active_j = dr.melt_stage(
            ts, t(jy_r["joint"]), t(jy_r["grain"]), tmt, torch.tensor(ml))
        n_gated += int((~active_j & (ts.mask_j > 0)).sum())
        js = js_next
    assert n_gated > 0


def assert_span_equal(ts, taux, js, jaux):
    for k in INTS:
        np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                      np.asarray(getattr(js, k)), err_msg=k)
    for k in ("xg", "xj"):
        np.testing.assert_allclose(getattr(ts, k).numpy(),
                                   np.asarray(getattr(js, k)), rtol=0,
                                   atol=POS_ATOL, err_msg=k)
    for k in ("grain_events", "extra_events", "switching", "message_edges",
              "ring_overflow", "pp_overflow", "elim_saturated",
              "nuc_overflow"):
        np.testing.assert_array_equal(taux[k].numpy(), np.asarray(jaux[k]),
                                      err_msg=k)
