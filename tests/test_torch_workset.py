"""The port's update_jit (its editor with the two-sided cleanup mask) and
its working-set editor (rollout.editor_workset) against the JAX package's
update_jit and workset_update, on the same inputs: the JAX forward of
random-init models on the 40 um generate-mode graph (seed 3, G 4, R 1),
and forced switches and eliminations on the 40 um seed-5 graph. Integer
state, switches and events are bit-equal; positions agree within 1e-6
(JAX's XLA editor rounds a switch's reposition differently from its
fused core, which the port's editor matches bit for bit)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graingraphnn_torch.rollout import editor_workset as ew
from graingraphnn_torch.rollout import topology_jit as ttj
from graingraphnn_tpu.models import grain_nn, hyper
from graingraphnn_tpu.rollout import device_rollout as jdr
from graingraphnn_tpu.rollout import editor_workset as jew
from graingraphnn_tpu.rollout import topology_jit as jtj
import chip_smoke
from tests.test_torch_editor import make_graph, scenario
from tests.test_torch_fixture import jax_start

INTS = ("E_pp", "E_pq", "mask_g", "mask_j", "append_ptr")
XJ_ATOL = 1e-6


def edit_inputs(rp, hp_r, cp, hp_c, state, r_threshold):
    """The editor's inputs after JAX's forward, as JAX's own workset test
    builds them."""
    _s, y_r, y_c, _ = jdr.forward_stage(rp, hp_r, cp, hp_c, state,
                                        jtj.RING_MAX)
    _xg, xj = jdr.integrate_stage(state, y_r["joint"], y_r["grain"], 6)
    ge, _ = jdr.elim_candidates(state, y_r["grain_area"], r_threshold)
    logits = jnp.where(state.E_pp[0] >= 0, y_c["edge_event"], jdr.NEG)
    tstate = jtj.TopoState(
        E_pp=state.E_pp, E_pq=state.E_pq, xj=xj, y_joint=y_r["joint"],
        mask_g=state.mask_g, mask_j=state.mask_j, append_ptr=state.n_pp)
    return tstate, logits, ge, y_r["grain"]


def port(tstate):
    return ttj.TopoState(**{
        k: torch.from_numpy(np.array(getattr(tstate, k)))
        for k in ("E_pp", "E_pq", "xj", "y_joint", "mask_g", "mask_j",
                  "append_ptr")})


def T(a):
    return torch.from_numpy(np.array(a))


def assert_same(ref, out):
    (s1, sw1, ex1), (s2, sw2, ex2) = ref, out
    for f in INTS:
        np.testing.assert_array_equal(getattr(s2, f).numpy(),
                                      np.asarray(getattr(s1, f)), err_msg=f)
    np.testing.assert_array_equal(sw2.numpy(), np.asarray(sw1))
    np.testing.assert_array_equal(ex2.numpy(), np.asarray(ex1))
    np.testing.assert_allclose(s2.xj.numpy(), np.asarray(s1.xj), rtol=0,
                               atol=XJ_ATOL)


@pytest.fixture(scope="module")
def setup():
    hp_r = hyper.regressor(0, layer_size=16)
    hp_c = hyper.classifier_transfered(1, layer_size=16)
    rp = grain_nn.init_regressor(jax.random.PRNGKey(0), hp_r)
    cp = grain_nn.init_classifier(jax.random.PRNGKey(1), hp_c,
                                  regressor_params=rp)
    _traj, hg0 = jax_start(40, 3, 4.0, 1.0)
    st = jdr.state_from_heterograph(hg0)
    inputs = jax.jit(lambda s, rt: edit_inputs(rp, hp_r, cp, hp_c, s, rt))
    NG = st.xg.shape[0]

    def workset(s, lg, g, y, ct, wq=1024, wp=1024):
        return jew.workset_update(s, lg, g, y, ct, NG, wq=wq, wp=wp)

    return st, inputs, jax.jit(workset, static_argnames=("wq", "wp"))


def jax_topo(ts):
    return jtj.TopoState(**{k: jnp.asarray(getattr(ts, k).numpy()) for k in
                            ("E_pp", "E_pq", "xj", "y_joint", "mask_g",
                             "mask_j", "append_ptr")})


@pytest.fixture(scope="module")
def forced():
    """Forced switches and eliminations on the 40 um seed-5 graph, and
    three grains made two-sided before the edit (chip_smoke's case), with
    the cleanup mask that spares one of them."""
    g = make_graph()
    cases = []
    for seed, n_sw, n_el in ((11, 24, 4), (13, 30, 8), (5, 0, 2)):
        logits, ge, y_grain, y_joint, xj = scenario(g, seed, n_sw, n_el)
        js = jtj.TopoState(
            E_pp=jnp.asarray(g["E_pp"]), E_pq=jnp.asarray(g["E_pq"]),
            xj=jnp.asarray(xj), y_joint=jnp.asarray(y_joint),
            mask_g=jnp.asarray(g["mask_g"]), mask_j=jnp.asarray(g["mask_j"]),
            append_ptr=jnp.asarray(g["n_pp"], jnp.int32))
        cases.append((js, logits, ge, y_grain, None))
    ts = port(cases[0][0])
    ts2, logits, ge, yg, cg = chip_smoke.two_sided_inputs(ts, seed=1)
    cases.append((jax_topo(ts2), logits.numpy(), ge.numpy(), yg.numpy(),
                  cg.numpy()))
    return cases


@pytest.mark.parametrize("mask", ["none", "half", "spare_one"])
def test_update_jit_matches_jax(forced, mask):
    """update_jit with no cleanup mask, a random half of the grains, and
    (on the two-sided case) every grain but one of those the cleanup
    deletes: that mask must change the edit, so it is honoured."""
    changed = 0
    for js, logits, ge, y_grain, spare in forced:
        NG = js.mask_g.shape[0]
        ts = port(js)
        cg = None
        if mask == "half":
            cg = np.random.default_rng(NG).uniform(size=NG) < 0.5
        elif mask == "spare_one":
            cg = spare
        ref = jtj.update_jit(js, jnp.asarray(logits), jnp.asarray(ge),
                             jnp.asarray(y_grain), 0.6, NG,
                             cleanup_g_mask=None if cg is None
                             else jnp.asarray(cg))
        out = ttj.update_jit(ts, T(logits), T(ge), T(y_grain), 0.6, NG,
                             cleanup_g_mask=None if cg is None
                             else torch.from_numpy(cg))
        assert_same(ref, out)
        plain = ttj.update_jit(ts, T(logits), T(ge), T(y_grain), 0.6, NG)
        changed += not torch.equal(plain[0].mask_g, out[0].mask_g)
    if mask == "spare_one":
        assert changed == 1


@pytest.mark.parametrize("ct,rt", [(0.99, 1e-4), (0.5, 1e-4), (0.5, 0.05),
                                   (0.3, 0.2)])
def test_workset_update_matches_jax(setup, ct, rt):
    """Quiet, switch-heavy and cascade-heavy spans (JAX's own thresholds):
    the port's working-set edit equals JAX's, and the port's full edit."""
    st, inputs, ws = setup
    NG = st.xg.shape[0]
    tstate, logits, ge, y_g = inputs(st, rt)
    ref = ws(tstate, logits, ge, y_g, jnp.float32(ct))
    ts = port(tstate)
    out = ew.workset_update(ts, T(logits), T(ge), T(y_g), np.float32(ct),
                            NG)
    assert_same(ref, out)
    full = ttj.update_jit(ts, T(logits), T(ge), T(y_g), np.float32(ct), NG)
    for a, b in zip((out[0].E_pp, out[0].E_pq, out[0].xj, out[1], out[2]),
                    (full[0].E_pp, full[0].E_pq, full[0].xj, full[1],
                     full[2])):
        assert torch.equal(a, b)


def test_workset_small_caps_fall_back(setup):
    """A working set too small for the span's footprint takes the full
    editor's second edit: still JAX's result."""
    st, inputs, ws = setup
    NG = st.xg.shape[0]
    tstate, logits, ge, y_g = inputs(st, 0.05)
    ts = port(tstate)
    info, _m, _l = ew.build_workset(ts, T(logits), T(ge), 0.5, wq=160,
                                    wp=160)
    assert bool(info.fallback)
    ref = ws(tstate, logits, ge, y_g, jnp.float32(0.5), wq=160, wp=160)
    out = ew.workset_update(ts, T(logits), T(ge), T(y_g), np.float32(0.5),
                            NG, wq=160, wp=160)
    assert_same(ref, out)


def test_workset_dead_tail_invariant(setup):
    """A live last E_pq column breaks the fill-sentinel invariant: the
    check flags it and the edit is the full editor's, as in JAX."""
    st, inputs, ws = setup
    NG = st.xg.shape[0]
    tstate, logits, ge, y_g = inputs(st, 1e-4)
    bad = tstate._replace(E_pq=tstate.E_pq.at[:, -1].set(
        jnp.asarray([0, 0])))
    ts = port(bad)
    info, _m, _l = ew.build_workset(ts, T(logits), T(ge), 0.6, wq=1024,
                                    wp=1024)
    assert bool(info.fallback)
    ref = ws(bad, logits, ge, y_g, jnp.float32(0.6))
    out = ew.workset_update(ts, T(logits), T(ge), T(y_g), np.float32(0.6),
                            NG)
    assert_same(ref, out)


@pytest.mark.parametrize("ct", [0.5, 0.99])
def test_workset_footprint_matches_jax(setup, ct):
    """The footprint, its guard shells, the selected columns and the mini
    state are JAX's bit for bit."""
    st, inputs, _ws = setup
    tstate, logits, ge, _y = inputs(st, 0.05)
    jinfo, jmini, jlg = jax.jit(jew.build_workset,
                                static_argnames=("wq", "wp"))(
        tstate, logits, ge, jnp.float32(ct), wq=1024, wp=1024)
    info, mini, lg = ew.build_workset(port(tstate), T(logits), T(ge),
                                      np.float32(ct), wq=1024, wp=1024)
    for f in ("q_cols", "p_cols", "n_p", "fallback", "shell_j", "shell_g",
              "fp_g"):
        np.testing.assert_array_equal(getattr(info, f).numpy(),
                                      np.asarray(getattr(jinfo, f)),
                                      err_msg=f)
    for f in INTS:
        np.testing.assert_array_equal(getattr(mini, f).numpy(),
                                      np.asarray(getattr(jmini, f)),
                                      err_msg=f)
    np.testing.assert_array_equal(lg.numpy(), np.asarray(jlg))
