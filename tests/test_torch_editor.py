"""The port's plain topology editor (the CUDA editor kernel's oracle) against
the JAX package's fused editor core run as plain XLA
(update_fused(use_pallas=False)), on a generate-mode 40 um graph with
switches and grain eliminations forced the way the JAX package's own
fused-editor tests force them. Integer outputs must be bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graingraphnn_torch.kernels import editor_fused
from graingraphnn_torch.rollout import topology_jit as ttj
from graingraphnn_tpu.data import extraction
from graingraphnn_tpu.graph import schema
from graingraphnn_tpu.kernels import editor_pallas as epal
from graingraphnn_tpu.rollout import topology_jit as tj
from tests.test_device_rollout import make_traj

SLACK = 64
INTS = ("E_pp", "E_pq", "mask_g", "mask_j", "append_ptr")


def make_graph():
    hg0 = extraction.make_test_sample(make_traj(5), span=6)
    jj = np.asarray(hg0.edge_index_dicts[schema.EDGE_TYPES[2]], np.int64)
    jj = jj[:, jj[0] >= 0]
    jg = np.asarray(hg0.edge_index_dicts[schema.EDGE_TYPES[1]], np.int64)
    xj = np.asarray(hg0.feature_dicts["joint"], np.float32)
    xg = np.asarray(hg0.feature_dicts["grain"], np.float32)
    mg = np.asarray(hg0.mask["grain"], np.int32).reshape(-1)
    E_pp = np.full((2, jj.shape[1] + SLACK), -1, np.int32)
    E_pp[:, : jj.shape[1]] = jj
    E_pq = np.full((2, jg.shape[1] + 1), -1, np.int32)
    E_pq[:, : jg.shape[1]] = jg
    return {"E_pp": E_pp, "E_pq": E_pq, "xj": xj, "mask_g": mg,
            "mask_j": np.ones(len(xj), np.int32), "n_pp": jj.shape[1],
            "grain_x": xg[:, 0]}


@pytest.fixture(scope="module")
def graph():
    return make_graph()


def scenario(g, seed, n_switch, n_elim):
    rng = np.random.default_rng(seed)
    E = g["E_pp"]
    logits = np.full(E.shape[1], -1e30, np.float32)
    logits[E[0] >= 0] = -50.0
    cand = np.nonzero((E[0] < E[1]) & (E[0] >= 0))[0]
    picks = rng.choice(len(cand), size=n_switch, replace=False)
    logits[cand[picks]] = rng.uniform(5.0, 15.0, size=n_switch)
    jg = g["E_pq"][1]
    grains, counts = np.unique(jg[jg >= 0], return_counts=True)
    small = grains[np.argsort(counts, kind="stable")][:8]
    ge = np.full(tj.MAX_ELIM, -1, np.int32)
    ge[:n_elim] = rng.choice(small, size=n_elim, replace=False)
    NG, NJ = len(g["mask_g"]), len(g["xj"])
    y_grain = np.stack([rng.uniform(-0.5, 0.5, NG), np.zeros(NG)],
                       1).astype(np.float32)
    y_joint = rng.uniform(-0.9, 0.9, (NJ, 2)).astype(np.float32)
    xj = g["xj"].copy()
    xj[:, 6:8] = rng.uniform(-0.9, 0.9, (NJ, 2))
    return logits, ge, y_grain, y_joint, xj


def run_both(g, logits, ge, y_grain, y_joint, xj, threshold=0.6,
             active_j=None, active_g=None):
    """JAX's fused core and the port's plain editor on the same inputs,
    with the melt pool's windows (bool arrays) where given."""
    NG = len(g["mask_g"])
    opt = lambda a, f: None if a is None else f(a)  # noqa: E731
    js = tj.TopoState(
        E_pp=jnp.asarray(g["E_pp"]), E_pq=jnp.asarray(g["E_pq"]),
        xj=jnp.asarray(xj), y_joint=jnp.asarray(y_joint),
        mask_g=jnp.asarray(g["mask_g"]), mask_j=jnp.asarray(g["mask_j"]),
        append_ptr=jnp.asarray(g["n_pp"], jnp.int32),
        active_j=opt(active_j, jnp.asarray))
    ref = epal.update_fused(js, jnp.asarray(logits), jnp.asarray(ge),
                            jnp.asarray(y_grain), threshold, NG,
                            use_pallas=False,
                            active_g=opt(active_g, jnp.asarray))
    ts = ttj.TopoState(
        E_pp=torch.from_numpy(g["E_pp"]), E_pq=torch.from_numpy(g["E_pq"]),
        xj=torch.from_numpy(xj), y_joint=torch.from_numpy(y_joint),
        mask_g=torch.from_numpy(g["mask_g"]),
        mask_j=torch.from_numpy(g["mask_j"]),
        append_ptr=torch.tensor(g["n_pp"], dtype=torch.int32),
        active_j=opt(active_j, torch.from_numpy))
    out = editor_fused.update_fused(ts, torch.from_numpy(logits),
                                    torch.from_numpy(ge),
                                    torch.from_numpy(y_grain), threshold, NG,
                                    active_g=opt(active_g, torch.from_numpy))
    return ref, out, ts


def jax_state(st):
    """JAX's TopoState of the port's."""
    return tj.TopoState(**{k: None if v is None else jnp.asarray(v.numpy())
                           for k, v in vars(st).items()})


def assert_equal(ref, out):
    (s1, sw1, ex1), (s2, sw2, ex2) = ref, out
    for f in INTS:
        np.testing.assert_array_equal(getattr(s2, f).numpy(),
                                      np.asarray(getattr(s1, f)), err_msg=f)
    np.testing.assert_array_equal(sw2.numpy(), np.asarray(sw1))
    np.testing.assert_array_equal(ex2.numpy(), np.asarray(ex1))
    for f in ("xj", "y_joint"):
        np.testing.assert_allclose(getattr(s2, f).numpy(),
                                   np.asarray(getattr(s1, f)), rtol=0,
                                   atol=1e-6, err_msg=f)


@pytest.mark.parametrize("seed,n_switch,n_elim", [
    (0, 6, 2), (1, 6, 2), (7, 6, 2), (11, 24, 4), (13, 30, 8),
    (3, 8, 0), (5, 0, 2), (2, 0, 0)])
def test_plain_editor_matches_jax_fused_core(graph, seed, n_switch, n_elim):
    ref, out, ts = run_both(graph, *scenario(graph, seed, n_switch, n_elim))
    assert_equal(ref, out)
    s2, sw2, _ = out
    assert int((sw2[:, 0] >= 0).sum()) <= n_switch
    if n_elim:
        assert int((s2.mask_g != ts.mask_g).sum()) > 0
    # the input state is left as it was
    assert torch.equal(ts.E_pp, torch.from_numpy(graph["E_pp"]))


@pytest.mark.parametrize("seed", [17, 19])
def test_windowed_editor_matches_jax(graph, seed):
    """The melt pool's windows, active where x < 0.5, gate switches and
    ring collapses exactly as in JAX's fused core; the windows change the
    edit (as tests/test_device_rollout.py:846-851 asks of JAX's)."""
    args = scenario(graph, seed, 24, 8)
    active_j = args[4][:, 0] < 0.5
    active_g = graph["grain_x"] < 0.5
    ref, out, _ = run_both(graph, *args, active_j=active_j,
                           active_g=active_g)
    assert_equal(ref, out)
    _, ungated, _ = run_both(graph, *args)
    assert not (torch.equal(out[0].mask_g, ungated[0].mask_g)
                and torch.equal(out[1], ungated[1]))


def test_plain_editor_matches_jax_on_chained_edits(graph):
    """Three edits in a row, each on the previous one's output, so later
    edits meet appended columns and dead sentinels mid-array."""
    g = dict(graph)
    for seed in (21, 22, 23):
        logits, ge, y_grain, y_joint, xj = scenario(g, seed, 16, 3)
        ref, out, _ = run_both(g, logits, ge, y_grain, y_joint, xj)
        assert_equal(ref, out)
        s = out[0]
        g = {"E_pp": s.E_pp.numpy(), "E_pq": s.E_pq.numpy(),
             "xj": s.xj.numpy(), "mask_g": s.mask_g.numpy(),
             "mask_j": s.mask_j.numpy(), "n_pp": int(s.append_ptr)}


def test_threshold_is_compared_in_float32(graph):
    """A probability equal to the float32 rounding of the threshold is not
    above it, in both packages."""
    logits, ge, y_grain, y_joint, xj = scenario(graph, 4, 0, 0)
    E = graph["E_pp"]
    col = int(np.nonzero((E[0] < E[1]) & (E[0] >= 0))[0][5])
    thr = float(torch.sigmoid(torch.tensor(3.0)))
    logits[col] = 3.0
    ref, out, _ = run_both(graph, logits, ge, y_grain, y_joint, xj, thr)
    assert_equal(ref, out)


def test_forced_elimination_matches_jax(graph):
    """A chain of edits that ends in a ring collapse forcing a three-sided
    neighbour out (chip_smoke.forced_out_chain), each edit held to JAX."""
    from chip_smoke import forced_out_chain

    NG = len(graph["mask_g"])
    ts0 = ttj.TopoState(
        E_pp=torch.from_numpy(graph["E_pp"]),
        E_pq=torch.from_numpy(graph["E_pq"]),
        xj=torch.from_numpy(graph["xj"]),
        y_joint=torch.zeros(len(graph["xj"]), 2),
        mask_g=torch.from_numpy(graph["mask_g"]),
        mask_j=torch.from_numpy(graph["mask_j"]),
        append_ptr=torch.tensor(graph["n_pp"], dtype=torch.int32))
    chain = forced_out_chain(ts0)
    assert len(chain) >= 2
    for st, logits, ge, yg in chain:
        js = jax_state(st)
        ref = epal.update_fused(js, jnp.asarray(logits.numpy()),
                                jnp.asarray(ge.numpy()),
                                jnp.asarray(yg.numpy()), 0.6, NG,
                                use_pallas=False)
        out = editor_fused.update_fused(st, logits, ge, yg, 0.6, NG)
        assert_equal(ref, out)
    forced = out[2][out[2] >= 0]
    assert len(forced) == 1 and int(out[0].mask_g[forced[0]]) == 0


def test_clustered_switches_match_jax(graph):
    """Switches on every jj edge around a few neighbouring grains
    (chip_smoke.clustered_switch_inputs): later events share joints with
    earlier ones, so the lookahead's choices are held to JAX too."""
    from chip_smoke import clustered_switch_inputs

    NG = len(graph["mask_g"])
    ts0 = ttj.TopoState(
        E_pp=torch.from_numpy(graph["E_pp"]),
        E_pq=torch.from_numpy(graph["E_pq"]),
        xj=torch.from_numpy(graph["xj"]),
        y_joint=torch.zeros(len(graph["xj"]), 2),
        mask_g=torch.from_numpy(graph["mask_g"]),
        mask_j=torch.from_numpy(graph["mask_j"]),
        append_ptr=torch.tensor(graph["n_pp"], dtype=torch.int32))
    st, logits, ge, yg = clustered_switch_inputs(ts0, range(0, 30, 5))
    js = jax_state(st)
    ref = epal.update_fused(js, jnp.asarray(logits.numpy()),
                            jnp.asarray(ge.numpy()), jnp.asarray(yg.numpy()),
                            0.6, NG, use_pallas=False)
    out = editor_fused.update_fused(st, logits, ge, yg, 0.6, NG)
    assert_equal(ref, out)
    assert int((out[1][:, 0] >= 0).sum()) >= 8
