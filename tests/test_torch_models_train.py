"""The modules the training port adds, against the JAX package on the same
inputs: building and packing samples, the synthetic graphs, segment ops,
the conv without attention and its COO reference, the history LSTM, the
SAGE and PGC cells, the regressor variants (layers=2, history, edge_len)
and the initialisers' parameter trees. Weights come from the JAX
initialisers and are carried over with params_from_jax; inputs are
tests.util graphs and the synthetic graphs, drawn from seeds with numpy."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graingraphnn_torch.graph import state, synthetic
from graingraphnn_torch.models import cells, grain_nn, hyper, lstm
from graingraphnn_torch.ops import period_conv as tpc
from graingraphnn_torch.ops import segment
from graingraphnn_torch.train import checkpoint
from graingraphnn_tpu.graph import state as jstate
from graingraphnn_tpu.graph import synthetic as jsynthetic
from graingraphnn_tpu.models import cells as jcells
from graingraphnn_tpu.models import grain_nn as jgn
from graingraphnn_tpu.models import hyper as jhyper
from graingraphnn_tpu.models import lstm as jlstm
from graingraphnn_tpu.ops import period_conv as jpc
from graingraphnn_tpu.ops import segment as jseg
from tests.util import synthetic_coo, synthetic_sample

ATOL = 2e-5   # fp32, the same sums in another order
CAPS = dict(grain_cap=24, joint_cap=40, jj_edge_cap=104)   # padded rows


def to_port(js) -> state.GraphSample:
    """The port's sample holding a JAX sample's arrays."""
    return state.GraphSample(**{
        f.name: torch.from_numpy(np.array(getattr(js, f.name)))
        for f in dataclasses.fields(state.GraphSample)})


def load_into(module, tree):
    """Copy a JAX parameter (sub)tree into a port module, names matching."""
    flat = checkpoint._flatten(tree)
    params = dict(module.named_parameters())
    assert set(flat) == set(params), sorted(set(flat) ^ set(params))
    with torch.no_grad():
        for name, p in params.items():
            p.copy_(torch.from_numpy(np.array(flat[name])))
    return module


def close(out, ref, atol=ATOL):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# samples
# ---------------------------------------------------------------------------


def test_build_sample_matches_jax_field_by_field():
    f, e, w, m = synthetic_coo(16, 32, seed=3)
    rng = np.random.default_rng(3)
    targets = {"grain": rng.uniform(-1, 1, (16, 2)),
               "joint": rng.uniform(-1, 1, (32, 2)),
               "grain_event": (rng.uniform(size=16) < 0.2),
               "edge_event": rng.choice([-100.0, 0.0, 1.0], 96),
               "edge": rng.uniform(-1, 1, 96),
               "edge_mask": rng.uniform(size=96) < 0.7}
    ref = jstate.build_sample(f, e, w, m, targets, **CAPS)
    out = state.build_sample(f, e, w, m, targets, device="cpu", **CAPS)
    for fld in dataclasses.fields(state.GraphSample):
        a, b = getattr(out, fld.name), np.asarray(getattr(ref, fld.name))
        assert a.numpy().dtype == b.dtype, fld.name
        np.testing.assert_array_equal(a.numpy(), b, err_msg=fld.name)


def test_stack_and_pack_offset_indices_per_sample():
    samples = [to_port(synthetic_sample(seed=s, with_targets=True, **CAPS))
               for s in range(3)]
    b = state.stack(samples)
    assert b.grain_x.shape == (3, 24, 11) and b.n_joint_rows.shape == (3,)
    p = state.pack(b)
    NG, NJ = 24, 40
    assert p.grain_x.shape == (3 * NG, 11) and p.push_nbr.shape == (3 * NJ, 3)
    assert p.jj_src.shape == (3 * 104,) and p.n_grain_rows.shape == (3,)
    for i, s in enumerate(samples):
        for name, step, rows in (("push_nbr", NG, NJ), ("connect_nbr", NJ, NJ),
                                 ("pull_nbr", NJ, NG), ("jj_src", NJ, 104),
                                 ("jj_dst", NJ, 104)):
            got = getattr(p, name)[i * rows:(i + 1) * rows]
            assert torch.equal(got, getattr(s, name) + i * step), name
        # masked slots stay inside their own sample
        lo, hi = i * NJ, (i + 1) * NJ
        slots = p.connect_nbr[i * NJ:(i + 1) * NJ]
        assert bool(((slots >= lo) & (slots < hi)).all())
    assert torch.equal(p.y_joint.reshape(3, NJ, 2), b.y_joint)


@pytest.mark.parametrize("make,ng", [("spatial_ring_arrays", 120),
                                     ("spatial_ring_arrays", 30),
                                     ("brick_wall_arrays", 24)])
def test_synthetic_graphs_match_jax(make, ng):
    ours = getattr(synthetic, make)(ng, seed=4)
    theirs = getattr(jsynthetic, make)(ng, seed=4)
    for a, b in zip(ours, theirs):
        if b is None:
            assert a is None
            continue
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=str(k))
    # 120 grains and 240 joints: the 40 um training patch's size
    s = state.build_sample(*ours, device="cpu")
    assert s.joint_x.shape[0] == 2 * ng


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


def test_segment_ops_match_jax_with_empty_segments():
    rng = np.random.default_rng(1)
    E, N = 60, 13
    ids = rng.integers(0, N - 2, E).astype(np.int32)     # two empty segments
    logits = rng.normal(0, 3, E).astype(np.float32)
    mask = (rng.uniform(size=E) < 0.7).astype(np.float32)
    vals = rng.normal(size=(E, 5)).astype(np.float32)
    ref = jseg.segment_softmax(jnp.asarray(logits), jnp.asarray(ids), N,
                               mask=jnp.asarray(mask))
    out = segment.segment_softmax(torch.from_numpy(logits),
                                  torch.from_numpy(ids), N,
                                  mask=torch.from_numpy(mask))
    close(out, ref, 1e-6)
    ref = jseg.segment_softmax(jnp.asarray(logits), jnp.asarray(ids), N)
    close(segment.segment_softmax(torch.from_numpy(logits),
                                  torch.from_numpy(ids), N), ref, 1e-6)
    ref = jseg.segment_sum(jnp.asarray(vals), jnp.asarray(ids), N)
    close(segment.segment_sum(torch.from_numpy(vals), torch.from_numpy(ids), N),
          ref, 1e-6)


def _conv_case(seed, G, C, K, Ns=23, Nd=19, Fs=11, Fd=8):
    rng = np.random.default_rng(seed)
    params = jpc.init_period_conv(jax.random.PRNGKey(seed), Fs, Fd, C, G)
    # non-zero biases, so the test sees them
    params = jax.tree_util.tree_map(
        lambda a: a + rng.normal(0, 0.1, a.shape).astype(np.float32), params)
    xs = rng.uniform(0, 1, (Ns, Fs)).astype(np.float32)
    xd = rng.uniform(0, 1, (Nd, Fd)).astype(np.float32)
    nbr = rng.integers(0, Ns, (Nd, K)).astype(np.int32)
    ln = rng.uniform(0, 0.3, (Nd, K)).astype(np.float32)
    mask = (rng.uniform(size=(Nd, K)) < 0.7).astype(np.float32)
    mask[::5] = 0.0
    conv = load_into(tpc.PeriodConv(Fs, Fd, C, G), params)
    return params, conv, (xs, xd, nbr, ln, mask)


@pytest.mark.parametrize("G,C,K", [(1, 8, 3), (4, 8, 16)])
def test_conv_without_attention_matches_jax(G, C, K):
    params, conv, arrays = _conv_case(G + K, G, C, K)
    ref = jpc.apply_period_conv(params, *map(jnp.asarray, arrays),
                                num_gates=G, out_channels=C, attention=False)
    out = tpc.apply_period_conv(conv, *map(torch.from_numpy, arrays),
                                num_gates=G, out_channels=C, kernels=True,
                                attention=False)
    close(out, ref)


@pytest.mark.parametrize("G,C", [(1, 8), (4, 8)])
def test_coo_reference_matches_jax_and_the_ell_conv(G, C):
    params, conv, (xs, xd, nbr, ln, mask) = _conv_case(30 + G, G, C, 5)
    Nd, K = nbr.shape
    dst = np.repeat(np.arange(Nd, dtype=np.int32), K)
    coo = (xs, xd, nbr.reshape(-1), dst, ln.reshape(-1), mask.reshape(-1))
    ref = jpc.apply_period_conv_coo_reference(
        params, *map(jnp.asarray, coo), num_gates=G, out_channels=C)
    out = tpc.apply_period_conv_coo_reference(
        conv, *map(torch.from_numpy, coo), num_gates=G, out_channels=C)
    close(out, ref)
    ell = tpc.apply_period_conv_plain(
        conv, *map(torch.from_numpy, (xs, xd, nbr, ln, mask)), num_gates=G,
        out_channels=C)
    close(out, ell.detach().numpy())


# ---------------------------------------------------------------------------
# history LSTM and cells
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dim,seq_len", [(1, 1), (2, 1), (2, 3)])
def test_history_inputs_matches_jax(dim, seq_len):
    x = np.random.default_rng(dim).normal(size=(7, 12)).astype(np.float32)
    ref = jlstm.history_inputs(jnp.asarray(x), dim, seq_len)
    out = lstm.history_inputs(torch.from_numpy(x), dim, seq_len)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("D,T", [(1, 1), (2, 3)])
def test_lstm_matches_jax(D, T):
    H = 16
    params = jlstm.init_lstm(jax.random.PRNGKey(D + T), D, H)
    x = np.random.default_rng(T).normal(size=(9, T, D)).astype(np.float32)
    ref = jlstm.apply_lstm(params, jnp.asarray(x), H)
    out = load_into(lstm.LSTM(D, H), params)(torch.from_numpy(x))
    close(out, ref, 1e-6)


def _state(rng, NG, NJ, C):
    a = {k: rng.normal(0, 0.5, (n, C)).astype(np.float32)
         for k, n in (("hg", NG), ("hj", NJ), ("cg", NG), ("cj", NJ))}
    j = ({"grain": jnp.asarray(a["hg"]), "joint": jnp.asarray(a["hj"])},
         {"grain": jnp.asarray(a["cg"]), "joint": jnp.asarray(a["cj"])})
    t = ({"grain": torch.from_numpy(a["hg"]), "joint": torch.from_numpy(a["hj"])},
         {"grain": torch.from_numpy(a["cg"]), "joint": torch.from_numpy(a["cj"])})
    return j, t


@pytest.mark.parametrize("kind", ["sage", "pgc"])
def test_cell_step_matches_jax(kind):
    """One warm-started step of a SAGE cell (layers >= 1: input width C) or
    of the non-recurrent PGC cell, at width 16 on a padded sample."""
    C = 16
    js = synthetic_sample(seed=5, **CAPS)
    ts = to_port(js)
    NG, NJ = 24, 40
    rng = np.random.default_rng(9)
    jst, tst = _state(rng, NG, NJ, C)
    if kind == "sage":
        params = jcells.init_sage_clstm(jax.random.PRNGKey(2), C, C, C)
        gi = rng.normal(size=(NG, C)).astype(np.float32)
        ji = rng.normal(size=(NJ, C)).astype(np.float32)
        jh, jc = jcells.apply_sage_clstm(params, js, jnp.asarray(gi),
                                         jnp.asarray(ji), jst, C)
        cell = load_into(cells.SageCLSTM(C, C, C), params)
        th, tc = cells.apply_cell(cell, ts, torch.from_numpy(gi),
                                  torch.from_numpy(ji), tst, C, kind="sage",
                                  kernels=True)
    else:
        params = jcells.init_pgc(jax.random.PRNGKey(3), 11, 8, C)
        jh, jc = jcells.apply_pgc(params, js, js.grain_x, js.joint_x, jst, C)
        cell = load_into(cells.PGC(11, 8, C), params)
        th, tc = cells.apply_pgc(cell, ts, ts.grain_x, ts.joint_x, tst, C,
                                 kernels=True)
    for a, b in ((th, jh), (tc, jc)):
        for k in ("grain", "joint"):
            close(a[k], b[k])


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

VARIANTS = {"layers2": {"layers": 2}, "history": {"history": True},
            "edge_len": {"edge_len": True}}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_regressor_variant_matches_jax_on_a_packed_batch(variant):
    """The regressor with a deferred option at width 16, JAX's per-sample
    outputs against the port's on the packed batch of the same samples."""
    hp = jhyper.regressor(0, layer_size=16, **VARIANTS[variant])
    params = jgn.init_regressor(jax.random.PRNGKey(11), hp)
    js = [synthetic_sample(seed=s, with_targets=True, **CAPS) for s in range(3)]
    ref = jax.vmap(lambda s: jgn.apply_regressor(params, hp, s))(
        jstate.stack(js))
    model = checkpoint.params_from_jax(params, hyper.HyperParams(
        **dataclasses.asdict(hp)), device="cpu")
    with torch.no_grad():
        out = model(state.pack(state.stack([to_port(s) for s in js])),
                    kernels=True)
    assert sorted(out) == sorted(ref)
    for k in ref:
        r = np.asarray(ref[k])
        close(out[k].reshape(r.shape), r)


def _bound(name, tree, C):
    """The half-width of the uniform distribution the JAX package draws
    `name` from (0 for its zero-initialised biases). tree: the flat JAX
    tree, for a layer's fan-in."""
    parts = name.split(".")
    mod, leaf = parts[-2], parts[-1]
    w = tree.get(name.rsplit(".", 1)[0] + ".w")
    if "lstm" in parts:
        return 1 / math.sqrt(C)                    # torch LSTM
    if "bias" in parts:
        return math.sqrt(6 / (1 + C))              # glorot gate bias
    if mod in ("key", "query", "value", "skip"):
        return 0.0 if leaf == "b" else math.sqrt(6 / (w.shape[0] + C))
    if mod == "l2":
        return 0.0 if leaf == "b" else math.sqrt(6 / (2 * C))
    if mod == "edge":
        return math.sqrt(6 / (1 + C))
    if mod == "r" and leaf == "b":
        return 0.0                                 # SAGE root, no bias
    return 1 / math.sqrt(w.shape[0])               # torch Linear


@pytest.mark.parametrize("config", ["regressor", "classifier", "layers2",
                                    "history", "edge_len"])
def test_init_trees_match_jax(config):
    """Keys and shapes equal to the JAX initialiser's; every weight inside
    its Glorot or torch bound and spread over it; zero exactly where JAX's
    is zero."""
    if config == "classifier":
        hp = jhyper.classifier_transfered(1, layer_size=16)
        jtree = jgn.init_classifier(jax.random.PRNGKey(0), hp)
    else:
        hp = jhyper.regressor(0, layer_size=16, **VARIANTS.get(config, {}))
        jtree = jgn.init_regressor(jax.random.PRNGKey(0), hp)
    php = hyper.HyperParams(**dataclasses.asdict(hp))
    gen = torch.Generator().manual_seed(0)
    model = (grain_nn.init_classifier(php, gen) if config == "classifier"
             else grain_nn.init_regressor(php, gen))
    theirs = {k: np.asarray(v) for k, v in checkpoint._flatten(jtree).items()}
    ours = {k: v.detach().numpy() for k, v in model.named_parameters()}
    assert sorted(ours) == sorted(theirs)
    for k, want in theirs.items():
        got = ours[k]
        assert got.shape == want.shape, k
        assert (np.abs(want) == 0).all() == (np.abs(got) == 0).all(), k
        bound = _bound(k, theirs, hp.layer_size)
        for a in (got, want):
            assert np.abs(a).max() <= bound * (1 + 1e-6), k
            if a.size >= 8 and bound > 0:
                assert np.abs(a).max() > 0.5 * bound, k


def test_init_classifier_copies_the_regressor_stacks():
    hp_r = hyper.regressor(0, layer_size=8)
    hp_c = hyper.classifier_transfered(1, layer_size=8)
    reg = grain_nn.init_regressor(hp_r, torch.Generator().manual_seed(1))
    cls = grain_nn.init_classifier(hp_c, torch.Generator().manual_seed(2),
                                   regressor=reg)
    for name in ("encoder", "decoder"):
        a = getattr(reg, name).state_dict()
        b = getattr(cls, name).state_dict()
        assert a.keys() == b.keys()
        assert all(torch.equal(a[k], b[k]) for k in a)
    # copies, not shared tensors
    with torch.no_grad():
        reg.encoder[0].bias["grain"].add_(1.0)
    assert not torch.equal(reg.encoder[0].bias["grain"],
                           cls.encoder[0].bias["grain"])
    assert grain_nn.count_params(cls) == jgn.count_params(
        jax.eval_shape(lambda k: jgn.init_classifier(
            k, jhyper.classifier_transfered(1, layer_size=8)),
            jax.random.PRNGKey(0)))
