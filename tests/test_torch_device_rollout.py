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
from tests.test_torch_fixture import jax_start

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
    tsample, tflags = dr.make_sample(port_state(js0))
    assert bool(tflags["ring_overflow"]) == bool(jover) is False
    assert not (bool(tflags["jg_overflow"]) or bool(tflags["jj_overflow"]))
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
    """What the port's driver refuses: the phase-field comparison on a
    trajectory that carries no truth (the generated fixture), and a
    partitioned rollout outside the ranks of a launch."""
    _, (reg, cls), _, _ = setup
    traj = dd.load_trajectory()
    for kw, err, what in (({"compare": True}, ValueError, "truth"),
                          ({"partition": 4}, ValueError,
                           "parallel.mesh.launch")):
        with pytest.raises(err, match=what):
            dd.run_device_resident(traj, reg, cls, device="cpu", **kw)


# ---------------------------------------------------------------------------
# persistent ELL column tables
# ---------------------------------------------------------------------------

def random_coo(rng, num_dst, E, deg, n_src=99, dead=0.2):
    """A padded COO list whose live destinations have at most deg edges."""
    dst = rng.integers(0, num_dst, E)
    src = rng.integers(0, n_src, E)
    off = rng.uniform(size=E) < dead
    for d in range(num_dst):
        cols = np.nonzero((dst == d) & ~off)[0]
        off[cols[deg:]] = True
    src[off], dst[off] = -1, -1
    return np.stack([src, dst]).astype(np.int32)


def random_edit(rng, E, num_dst, n_src=99, frac=0.1):
    """Kills, rewires and revivals of a copy of E."""
    E_new = E.copy()
    kill = rng.uniform(size=E.shape[1]) < frac
    E_new[:, kill] = -1
    rewire = (rng.uniform(size=E.shape[1]) < frac) & (E_new[0] >= 0)
    E_new[1, rewire] = rng.integers(0, num_dst, int(rewire.sum()))
    revive = (rng.uniform(size=E.shape[1]) < frac / 2) & (E_new[0] < 0)
    E_new[0, revive] = rng.integers(0, n_src, int(revive.sum()))
    E_new[1, revive] = rng.integers(0, num_dst, int(revive.sum()))
    return E_new


@pytest.mark.parametrize("dst_row", [0, 1])
@pytest.mark.parametrize("t_max", [3, 64])
def test_column_tables_bit_identical_to_jax(dst_row, t_max):
    """build_pull_cols, ell_from_cols, update_ell_cols, maintained_cols
    (t_max=3 forces its fallback) and update_pull_cols on random edits."""
    rng = np.random.default_rng(7 + dst_row)
    num_dst, E, ring = 40, 192, 6
    Ed = random_coo(rng, num_dst, E, ring)
    if dst_row == 0:
        Ed = Ed[::-1].copy()
    src, dst = Ed[1 - dst_row], Ed[dst_row]
    jcols, jov = jdr.build_pull_cols(jnp.asarray(src), jnp.asarray(dst),
                                     num_dst, ring)
    tcols, tov = dr.build_pull_cols(torch.from_numpy(src.copy()),
                                    torch.from_numpy(dst.copy()), num_dst,
                                    ring)
    np.testing.assert_array_equal(tcols.numpy(), np.asarray(jcols))
    assert bool(tov) == bool(jov) is False
    attr = rng.uniform(0.1, 1, E).astype(np.float32)
    for a, b in zip(dr.ell_from_cols(tcols, torch.from_numpy(src.copy()),
                                     torch.from_numpy(attr)),
                    jdr.ell_from_cols(jcols, jnp.asarray(src),
                                      jnp.asarray(attr))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    n_busts = 0
    for it in range(6):
        E_new = random_edit(rng, Ed, num_dst) if dst_row else \
            random_edit(rng, Ed[::-1].copy(), num_dst)[::-1].copy()
        ja, jb = jnp.asarray(Ed), jnp.asarray(E_new)
        ta, tb = torch.from_numpy(Ed), torch.from_numpy(E_new)
        ref = jdr.update_ell_cols(jcols, ja, jb, dst_row, t_max=t_max)
        out = dr.update_ell_cols(tcols, ta, tb, dst_row, t_max=t_max)
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        n_busts += bool(ref[1])
        ref = jdr.maintained_cols(jcols, ja, jb, dst_row, t_max=t_max)
        out = dr.maintained_cols(tcols, ta, tb, dst_row, t_max=t_max)
        for a, b in zip(out, ref):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        if dst_row == 1:
            ref = jdr.update_pull_cols(jcols, ja, jb, t_max=t_max)
            out = dr.update_pull_cols(tcols, ta, tb, t_max=t_max)
            for a, b in zip(out, ref):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
        if bool(out[1]):                 # a degree past the ring: restart
            continue
        Ed, jcols, tcols = E_new, ref[0], out[0]
    assert (n_busts > 0) == (t_max == 3)


@pytest.fixture(scope="module")
def small40():
    """The 40 um graph with random narrow models that eliminate often
    (r_threshold 0.05), as the JAX package's own test of its columns."""
    from graingraphnn_tpu.models import grain_nn, hyper

    traj, hg0 = jax_start(40, 5, 4.0, 1.0)
    hp_r = hyper.regressor(0, layer_size=16)
    hp_c = hyper.classifier_transfered(1, layer_size=16)
    rp = grain_nn.init_regressor(jax.random.PRNGKey(0), hp_r)
    cp = grain_nn.init_classifier(jax.random.PRNGKey(1), hp_c,
                                  regressor_params=rp)
    models = (checkpoint.params_from_jax(rp, hp_r, "cpu"),
              checkpoint.params_from_jax(cp, hp_c, "cpu"))
    return hg0, (rp, hp_r, cp, hp_c), models


SMALL_KW = dict(c_threshold=0.5, r_threshold=0.05)
COLS = ("pull_cols", "push_cols", "connect_cols")


def test_incremental_spans_match_the_sort_builder(small40):
    """Three spans on the column tables equal three spans rebuilt by the
    sort, also with a touch budget of 2 that takes the fallback every
    span; the tables at the end equal tables built from scratch."""
    hg0, _, (reg, cls) = small40
    st_inc = dr.state_from_heterograph(hg0, incremental=True, device="cpu")
    st_srt = dr.state_from_heterograph(hg0, incremental=False, device="cpu")
    s_i, _ = dr.make_sample(st_inc)
    s_s, _ = dr.make_sample(st_srt)
    for f in ("pull_nbr", "pull_len", "pull_mask", "push_nbr", "push_len",
              "push_mask", "connect_nbr", "connect_len", "connect_mask"):
        np.testing.assert_array_equal(getattr(s_i, f).numpy(),
                                      getattr(s_s, f).numpy(), err_msg=f)
    assert dr.state_from_heterograph(hg0, device="cpu").pull_cols is None
    outs = {}
    for name, st, touch_max in (("inc", st_inc, dr.TOUCH_MAX),
                                ("srt", st_srt, dr.TOUCH_MAX),
                                ("fallback", st_inc, 2)):
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(dr, "TOUCH_MAX", touch_max)
            outs[name] = dr.make_rollout(reg, cls, n_steps=3,
                                         **SMALL_KW)(st)
    assert int((outs["inc"][1]["grain_events"] >= 0).sum()) > 0
    for name in ("srt", "fallback"):
        for f in FIELDS:
            np.testing.assert_array_equal(
                getattr(outs["inc"][0], f).numpy(),
                getattr(outs[name][0], f).numpy(), err_msg=f"{name} {f}")
        for k in ("grain_events", "switching", "ring_overflow"):
            np.testing.assert_array_equal(outs["inc"][1][k].numpy(),
                                          outs[name][1][k].numpy())
    si = outs["inc"][0]
    for cols, (s, d, n, k) in zip(
            (si.pull_cols, si.push_cols, si.connect_cols),
            ((si.E_pq[0], si.E_pq[1], si.xg.shape[0], 16),
             (si.E_pq[1], si.E_pq[0], si.xj.shape[0], 3),
             (si.E_pp[0], si.E_pp[1], si.xj.shape[0], 3))):
        np.testing.assert_array_equal(cols.numpy(),
                                      dr.build_pull_cols(s, d, n, k)[0].numpy())


def test_incremental_span_matches_jax(small40):
    """Three spans on the column tables, each from the same JAX state: the
    tables the span leaves are bit-equal to JAX's maintained ones."""
    hg0, (rp, hp_r, cp, hp_c), (reg, cls) = small40
    js = jdr.state_from_heterograph(hg0, incremental=True)
    step = jax.jit(lambda s: jdr.device_step(rp, hp_r, cp, hp_c, s,
                                             fused_editor=True, **SMALL_KW))
    n_elim = 0
    for _ in range(3):
        js_next, jaux = step(js)
        ts = dr.DeviceRolloutState(**{
            k: torch.from_numpy(np.array(getattr(js, k)))
            for k in FIELDS + COLS})
        t_next, taux = dr.device_step(reg, cls, ts, **SMALL_KW)
        for k in INT_FIELDS + COLS:
            np.testing.assert_array_equal(getattr(t_next, k).numpy(),
                                          np.asarray(getattr(js_next, k)),
                                          err_msg=k)
        assert bool(taux["ring_overflow"]) == bool(jaux["ring_overflow"])
        n_elim += int((np.asarray(jaux["grain_events"]) >= 0).sum())
        js = js_next
    assert n_elim > 0


def test_tables_follow_nucleation_under_the_melt_pool(small40, monkeypatch):
    """Nucleating spans under the moving melt pool on the generated 40 um
    graph with nucleation slack: on the column tables, with the touch
    budget of TOUCH_MAX and of 2 (the fallback), the spans equal the sort
    builder's bit for bit (topology, cursors, positions), and after every
    span each table equals one built from scratch."""
    _, _, (reg, cls) = small40
    t = dd.generate_trajectory(40, 3, 4.0, 1.0)
    meltpool = {"r0": 20.0, "z0": 4.0, "melt_pool_angle": np.pi / 4}
    touches = []
    update = dr.update_ell_cols
    monkeypatch.setattr(dr, "update_ell_cols", lambda *a, **k: (
        lambda out: (touches.append(bool(out[1])), out)[1])(update(*a, **k)))
    n_steps = 4
    ends = {}
    for name, incremental, touch_max in (("srt", False, dr.TOUCH_MAX),
                                         ("inc", True, dr.TOUCH_MAX),
                                         ("fallback", True, 2)):
        monkeypatch.setattr(dr, "TOUCH_MAX", touch_max)
        st, offset_j, factor = dd.init_scaled_state(
            t.x, t.edges, t.mask, t.lxd, t.patch_size,
            incremental=incremental, nucleation_slack=dd.NUCLEATION_SLACK,
            device="cpu")
        term, gap = dd.make_melt_term(meltpool, t.lxd, 6, st.xj.shape[0],
                                      offset_j, factor, "cpu")
        rng = np.random.default_rng(0)
        n_g0 = int(st.n_g)
        del touches[:]
        states = []
        for i in range(n_steps):
            st, aux = dr.device_step(
                reg, cls, st, **SMALL_KW, nuc_density_term=10.0,
                nuc_rand=torch.from_numpy(rng.random(
                    st.xj.shape[0]).astype(np.float32)),
                nuc_angles=torch.from_numpy(rng.random(
                    (4, 2)).astype(np.float32)),
                melt_term=term, melt_left=torch.tensor(np.float32(i * gap)))
            assert not any(bool(aux[f]) for f in (
                "ring_overflow", "pp_overflow", "nuc_overflow"))
            states.append(st)
            if incremental:
                for cols, (src, dst, n, k) in zip(
                        (st.pull_cols, st.push_cols, st.connect_cols),
                        ((st.E_pq[0], st.E_pq[1], st.xg.shape[0], 16),
                         (st.E_pq[1], st.E_pq[0], st.xj.shape[0], 3),
                         (st.E_pp[0], st.E_pp[1], st.xj.shape[0], 3))):
                    np.testing.assert_array_equal(
                        cols.numpy(),
                        dr.build_pull_cols(src, dst, n, k)[0].numpy(),
                        err_msg=f"{name} span {i}")
        assert int(st.n_g) > n_g0, "no nucleation"
        if incremental:
            assert any(touches) == (touch_max == 2), name
        ends[name] = states
    for name in ("inc", "fallback"):
        for i, (a, b) in enumerate(zip(ends[name], ends["srt"])):
            for f in FIELDS + ("n_g", "n_j", "n_pq"):
                np.testing.assert_array_equal(
                    getattr(a, f).numpy(), getattr(b, f).numpy(),
                    err_msg=f"{name} span {i} {f}")
