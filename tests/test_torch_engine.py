"""The port's host rollout engine (graingraphnn_torch/rollout/engine.py)
against the JAX package's on the CPU, on generated 40 um graphs: the
padded sample and the forwards on it, one span from the same state in
every mode the engine has (host and device editors, nucleation, the
moving melt pool, temporal (G, R), interpolated frames, clamped thermal
features, ensembles; periodic and no-flux), the comparison with a
truth, and the CLI without --device_resident.

Each comparison is of ONE span from the same starting state: the rollout
is chaotic through its discrete events, so free-running spans part on a
reordered fp32 sum alone. Tolerances:
  - forwards on the same sample: rtol FWD_RTOL and atol FWD_ATOL for the
    narrow models, SHIPPED_ATOL for the shipped ones (fp32 sums
    reordered; the trained event logits reach 30 in magnitude);
  - topology (edges, masks, switches, forced eliminations): bit-equal,
    unless a switch probability lies within NEAR of the threshold;
  - positions and grain features after the span: atol POS_ATOL;
  - QoIs: event counts equal, misorientation and KS within rtol QOI_RTOL,
    layer errors and rasters equal.
"""

import contextlib
import copy
import io
import json
import math
import os

import jax
import numpy as np
import pytest

from graingraphnn_torch.cli import test as tcli
from graingraphnn_torch.data import extraction as tex
from graingraphnn_torch.graph import schema
from graingraphnn_torch.rollout import engine as teng
from graingraphnn_torch.train import checkpoint
from graingraphnn_tpu.cli import test as jcli
from graingraphnn_tpu.data import extraction as jex
from graingraphnn_tpu.data import heterograph as jhg
from graingraphnn_tpu.models import grain_nn, hyper
from graingraphnn_tpu.rollout import engine as jeng
from graingraphnn_tpu.train import checkpoint as jck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FWD_ATOL = FWD_RTOL = 1e-5
SHIPPED_ATOL = 1e-4    # the shipped models' forwards (tests/test_torch_models.py)
POS_ATOL = 1e-5
NEAR = 1e-5
QOI_RTOL = 1e-5
ONE_SPAN = 2.6       # growth height of one 6-frame span: int(2.6 / 0.4) = 6
# the narrow random models (event head scaled by LOGIT_SCALE): a threshold
# and an area cut that give switches and eliminations in one span
LOGIT_SCALE = 50.0
NARROW_KW = dict(c_threshold=0.6, r_threshold=0.014)
SHIPPED_KW = dict(c_threshold=0.9, r_threshold=3e-3)
# a melt pool window over the first 95 % of the domain: one span
ONE_SPAN_MELT = {"r0": 42.0, "z0": 4.0, "melt_pool_angle": math.pi / 4}


def trajectories(bc="periodic", seed=5, G=4.0, R=1.0):
    """The JAX package's and the port's generated 40 um trajectories of
    one (seed, G, R) with their t=0 samples: (jtraj, jhg0, ttraj, thg0)."""
    jt = jex.TrajectoryExtractor(lxd=40, seed=seed, frames=121, bc=bc,
                                 physical_params={"G": G, "R": R})
    jt.area_counts = dict(zip(*np.unique(jt.alpha_field,
                                         return_counts=True)))
    jt.area_traj.append(dict(jt.area_counts))
    jt.states.append(jhg.tensorize(jt, 0))
    tt = tex.generate(40, seed, G, R, bc=bc)
    return (jt, jex.make_test_sample(jt, span=6), tt,
            tex.make_test_sample(tt, span=6))


def narrow_models():
    """Layer-16 models with JAX's random init, carried to the port:
    {"jax": (reg, hp_r, cls, hp_c), "port": (reg, cls)}, and ensembles
    of 3 regressors and 2 classifiers under "jax_ens" / "port_ens". The
    classifiers' event head is scaled by LOGIT_SCALE: at random init its
    probabilities lie within 0.005 of 0.5."""
    hp_r = hyper.regressor(0, layer_size=16)
    hp_c = hyper.classifier_transfered(1, layer_size=16)
    regs = [grain_nn.init_regressor(jax.random.PRNGKey(k), hp_r)
            for k in (0, 5, 6)]
    clss = [grain_nn.init_classifier(jax.random.PRNGKey(k), hp_c,
                                     regressor_params=regs[0])
            for k in (1, 3)]
    for c in clss:
        c["lin2"] = {k: np.asarray(v) * LOGIT_SCALE
                     for k, v in c["lin2"].items()}
    port_r = [checkpoint.params_from_jax(p, hp_r, "cpu") for p in regs]
    port_c = [checkpoint.params_from_jax(p, hp_c, "cpu") for p in clss]
    return {"jax": (regs[0], hp_r, clss[0], hp_c),
            "port": (port_r[0], port_c[0]),
            "jax_ens": (regs, hp_r, clss, hp_c),
            "port_ens": (port_r, port_c)}


@pytest.fixture(scope="module")
def narrow():
    return narrow_models()


@pytest.fixture(scope="module")
def shipped():
    path = os.path.join(REPO, "artifacts", "40um")
    pr, hpr, _ = jck.load(os.path.join(path, "regressor0"))
    pc, hpc, _ = jck.load(os.path.join(path, "classifier1"))
    return {"jax": (pr, hpr, pc, hpc),
            "port": (checkpoint.params_from_jax(pr, hpr, "cpu"),
                     checkpoint.params_from_jax(pc, hpc, "cpu"))}


def engines(models, ens=False, **kw):
    jm = models["jax_ens" if ens else "jax"]
    tm = models["port_ens" if ens else "port"]
    return (jeng.RolloutEngine(*jm, **kw),
            teng.RolloutEngine(*tm, device="cpu", **kw))


def record(engine):
    """Keep each span's classifier logits and a copy of each edit's
    result (x, edges, switching, extra events, mask)."""
    log = {"logits": [], "edit": []}
    forward = engine._forward

    def fwd(*a, **k):
        out = forward(*a, **k)
        log["logits"].append(np.asarray(out[0][1]["edge_event"], np.float64))
        return out

    engine._forward = fwd
    for owner, name in ((engine, "_jit_update"), (engine.editor, "update")):
        def edit(x, edges, pred, mask, _orig=getattr(owner, name), **k):
            out = _orig(x, edges, pred, mask, **k)
            log["edit"].append(copy.deepcopy((*out, mask)))
            return out
        setattr(owner, name, edit)
    return log


def same_span(jlog, tlog, threshold, atol=FWD_ATOL):
    """Asserts one span's edit equal (topology bit-equal, positions within
    POS_ATOL) unless a probability lies within NEAR of the threshold, and
    the span's logits within rtol FWD_RTOL and `atol`. Returns (topology
    equal, threshold adjacent, switches, events)."""
    np.testing.assert_allclose(tlog["logits"][0], jlog["logits"][0],
                               rtol=FWD_RTOL, atol=atol)
    p = 1.0 / (1.0 + np.exp(-jlog["logits"][0]))
    near = bool((np.abs(p - threshold) < NEAR).any())
    (jx, je, jsw, jev, jm), (tx, te, tsw, tev, tm) = (jlog["edit"][0],
                                                     tlog["edit"][0])
    same = (all(np.array_equal(je[k], te[k]) for k in je)
            and all(np.array_equal(jm[k], tm[k]) for k in jm)
            and np.array_equal(jsw, tsw) and np.array_equal(jev, tev)
            and all(jx[k].shape == tx[k].shape for k in jx))
    assert same or near
    if same:
        for k in ("grain", "joint"):
            np.testing.assert_allclose(tx[k], jx[k], rtol=0, atol=POS_ATOL,
                                       err_msg=k)
    return same, near, len(jsw), len(jev)


def same_qois(rj, rt):
    for k in ("events_pred", "events_tp", "events_truth", "num_grains_final",
              "num_grains_live", "event_steps"):
        assert rt[k] == rj[k], k
    np.testing.assert_allclose(rt["misorientation"], rj["misorientation"],
                               rtol=QOI_RTOL)
    assert set(rt) == set(rj)


# mode: (engine options over NARROW_KW, run options); the temporal (G, R)
# and the ensemble's mean lower the probabilities, so their thresholds are
# lower
MODES = {
    "host": ({}, {}),
    "jit_editor": ({"jit_editor": True}, {}),
    "nucleation": ({"seed": 11}, {"nucleation_density": 1e-2}),
    "jit_nucleation": ({"seed": 11, "jit_editor": True},
                       {"nucleation_density": 1e-2}),
    "meltpool": ({}, {"meltpool": ONE_SPAN_MELT}),
    "jit_meltpool": ({"jit_editor": True}, {"meltpool": ONE_SPAN_MELT}),
    "temporal": ({"c_threshold": 0.2}, {"temporal": True}),
    "interp_frames": ({}, {"interp_frames": 2, "collect_fields": True}),
    "clamp_gr": ({}, {"clamp_gr": (1.904, 1.904, 0.558, 0.558)}),
    "ensemble": ({"ens": True, "c_threshold": 0.25, "r_threshold": 1e-2},
                 {}),
}
BCS = {mode: ["periodic"] if mode == "interp_frames"
       else ["periodic", "noflux"] for mode in MODES}


def run_pair(models, mode, bc):
    """One span of `mode` by both engines from the same state: (JAX
    result, port result, JAX log, port log, threshold, starting grains)."""
    eng_kw, run_kw = MODES[mode]
    eng_kw = {**NARROW_KW, **eng_kw}
    ens = eng_kw.pop("ens", False)
    jt, jh, tt, th = trajectories(bc)
    je, te = engines(models, ens, **eng_kw)
    jlog, tlog = record(je), record(te)
    kw = dict(span=6, compare=False,
              growth_height=-1 if "meltpool" in run_kw else ONE_SPAN,
              **run_kw)
    rj = je.run(jh, jt, **kw)
    rt = te.run(th, tt, **kw)
    assert len(jlog["edit"]) == len(tlog["edit"]) == 1
    return (rj, rt, jlog, tlog, eng_kw["c_threshold"],
            len(jh.feature_dicts["grain"]))


@pytest.mark.parametrize("mode,bc", [(m, b) for m in MODES for b in BCS[m]])
def test_one_span_matches_jax(narrow, mode, bc):
    """One span of each mode from the same generated state, periodic and
    no-flux: the edit (topology under the threshold exemption, positions)
    and the returned QoIs; each span switches and eliminates."""
    rj, rt, jlog, tlog, thr, n0 = run_pair(narrow, mode, bc)
    same, near, n_sw, _ = same_span(jlog, tlog, thr)
    assert n_sw > 0 and rj["events_pred"] > 0, rj["event_steps"]
    assert same        # no probability of these spans lies within NEAR
    same_qois(rj, rt)
    if MODES[mode][1].get("collect_fields"):
        assert len(rt["alpha_field_list"]) == 4   # frame 0, 2 blends, span
        for a, b in zip(rj["alpha_field_list"], rt["alpha_field_list"]):
            np.testing.assert_array_equal(a, b)
    if "nucleation_density" in MODES[mode][1]:
        assert rj["num_grains_final"] > n0


def test_interp_frames_under_noflux_fails_as_in_jax(narrow):
    """Interpolated frames under the no-flux boundary: the blended
    junctions miss the domain corners that the planar rebuild looks for,
    and both packages raise the same IndexError."""
    errors = []
    jt, jh, tt, th = trajectories("noflux")
    je, te = engines(narrow, **NARROW_KW)
    for eng, h, t in ((je, jh, jt), (te, th, tt)):
        with pytest.raises(IndexError) as err:
            eng.run(h, t, span=6, compare=False, growth_height=ONE_SPAN,
                    interp_frames=2)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_spans_eliminate_grains(narrow):
    """The narrow models' settings eliminate grains on the host and the
    device editor alike (so the one-span comparisons see eliminations)."""
    for jit in (False, True):
        jt, jh, tt, th = trajectories()
        je, te = engines(narrow, **NARROW_KW, jit_editor=jit)
        jlog, tlog = record(je), record(te)
        kw = dict(span=6, compare=False, growth_height=ONE_SPAN)
        rj, rt = je.run(jh, jt, **kw), te.run(th, tt, **kw)
        same, _, _, _ = same_span(jlog, tlog, NARROW_KW["c_threshold"])
        assert same and rt["events_pred"] > 0
        same_qois(rj, rt)


@pytest.mark.parametrize("jit_editor", [False, True])
def test_one_span_with_the_shipped_weights_matches_jax(shipped, jit_editor):
    """The shipped checkpoints at full width on the JAX package's generate
    recipe's graph (seed 3, G 4, R 1)."""
    jt, jh, tt, th = trajectories(seed=3)
    je, te = engines(shipped, **SHIPPED_KW, jit_editor=jit_editor)
    jlog, tlog = record(je), record(te)
    kw = dict(span=6, compare=False, growth_height=ONE_SPAN)
    rj, rt = je.run(jh, jt, **kw), te.run(th, tt, **kw)
    same, near, n_sw, _ = same_span(jlog, tlog, SHIPPED_KW["c_threshold"],
                                    SHIPPED_ATOL)
    assert same and n_sw > 0
    same_qois(rj, rt)


def truth_on(traj):
    """A truth written onto a generated trajectory: the frame-0 raster as
    every frame, grain events at frames 1 and 3, and volumes that grow
    with the frame (no excess volume)."""
    rng = np.random.default_rng(0)
    traj.alpha_pde_frames = np.repeat(traj.alpha_field.T[:, :, None], 121,
                                      axis=2)
    traj.grain_events = [set(), {3, 7}, set(), {11}] + [set()] * 117
    n = traj.num_regions
    traj.totalV_frames = (rng.uniform(1e3, 5e3, (n, 1))
                          * np.linspace(1.0, 3.0, 121)[None, :])
    traj.extraV_frames = np.zeros((n, 121))
    return traj


def test_compare_against_a_truth_matches_jax(narrow):
    """compare=True over two spans against the same truth: layer errors,
    event hits and the size-distribution KS."""
    jt, jh, tt, th = trajectories()
    truth_on(jt), truth_on(tt)
    je, te = engines(narrow, c_threshold=0.99, r_threshold=1e-4)
    kw = dict(span=6, compare=True, growth_height=ONE_SPAN)
    rj, rt = je.run(jh, jt, **kw), te.run(th, tt, **kw)
    assert rt["layer_err_list"] == rj["layer_err_list"]
    assert rt["layer_err_list"][0][1] == 0.0 < rt["final_layer_error"]
    for k in ("KS", "KS_p", "size_err"):
        np.testing.assert_allclose(rt[k], rj[k], rtol=QOI_RTOL, err_msg=k)
    same_qois(rj, rt)
    assert rt["events_truth"] == 3


def forced_ring(hg, ring=18):
    """The t=0 arrays with more pull edges into the grain of the largest
    ring, from junctions outside it, so that its ring has `ring` slots:
    past 16, and the engine sizes the sample's ring at 24 (push keeps its
    3 grains a junction)."""
    pull_t, push_t = schema.EDGE_TYPES[1], schema.EDGE_TYPES[0]
    x = {k: np.asarray(v, np.float32) for k, v in hg.feature_dicts.items()}
    pull = np.asarray(hg.edge_index_dicts[pull_t], np.int64)
    attr = {k: np.asarray(v, np.float64)
            for k, v in hg.edge_weight_dicts.items()}
    g = int(np.bincount(pull[1]).argmax())
    outside = np.setdiff1d(np.arange(len(x["joint"])), pull[0, pull[1] == g])
    extra = ring - int((pull[1] == g).sum())
    add = np.stack([outside[:extra], np.full(extra, g)])
    lens = np.linspace(0.05, 0.2, extra)[:, None]
    edges = {"pull": np.concatenate([pull, add], axis=1),
             "push": np.asarray(hg.edge_index_dicts[push_t], np.int64),
             "connect": np.asarray(hg.edge_index_dicts[schema.EDGE_TYPES[2]],
                                   np.int64)}
    attr[pull_t] = np.concatenate([attr[pull_t], lens])
    return x, edges, attr


@pytest.mark.parametrize("ring", [16, 24])
@pytest.mark.parametrize("weights", ["narrow", "shipped"])
def test_forward_on_the_same_sample_matches_jax(request, weights, ring):
    """_forward on the same padded sample at the engine's capacities: the
    samples bit-equal (ELL tables, masks, padding), the outputs within
    FWD_ATOL; ring 24 from a grain forced past 16 sides."""
    models = request.getfixturevalue(weights)
    atol = SHIPPED_ATOL if weights == "shipped" else FWD_ATOL
    jt, jh, _, _ = trajectories()
    if ring == 24:
        x, edges, attr = forced_ring(jh)
    else:
        x = {k: np.asarray(v, np.float32) for k, v in jh.feature_dicts.items()}
        edges = {k: np.asarray(jh.edge_index_dicts[et], np.int64)
                 for k, et in zip(("push", "pull", "connect"),
                                  schema.EDGE_TYPES)}
        attr = {k: np.asarray(v, np.float64)
                for k, v in jh.edge_weight_dicts.items()}
    caps = (128, 256, 768)
    mask = {"grain": np.ones((caps[0], 1), np.int64),
            "joint": np.ones((caps[1], 1), np.int64)}
    je, te = engines(models)
    for e in (je, te):
        e._mask, e._bc = mask, "periodic"
    (jr, jc), js = je._forward(x, edges, attr, caps)
    (tr, tc), ts = te._forward(x, edges, attr, caps)
    assert ts.pull_nbr.shape == (caps[0], ring) == js.pull_nbr.shape
    for f in ("grain_x", "joint_x", "grain_mask", "joint_mask", "push_nbr",
              "push_len", "push_mask", "connect_nbr", "connect_len",
              "connect_mask", "pull_nbr", "pull_len", "pull_mask", "jj_src",
              "jj_dst", "jj_len", "jj_mask"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    for k in jr:
        np.testing.assert_allclose(tr[k], np.asarray(jr[k]), rtol=FWD_RTOL,
                                   atol=atol, err_msg=k)
    for k in jc:
        np.testing.assert_allclose(tc[k], np.asarray(jc[k]), rtol=FWD_RTOL,
                                   atol=atol, err_msg=k)


def test_noflux_sample_leaves_out_the_boundary_grain(narrow):
    """Under the no-flux boundary grain 0's push and pull edges are left
    out of the sample, as in the JAX package."""
    _, _, tt, th = trajectories("noflux")
    _, te = engines(narrow)
    te._mask = {"grain": np.ones((len(th.feature_dicts["grain"]), 1)),
                "joint": np.ones((len(th.feature_dicts["joint"]), 1))}
    edges = {k: np.asarray(th.edge_index_dicts[et], np.int64)
             for k, et in zip(("push", "pull", "connect"), schema.EDGE_TYPES)}
    x = {k: np.asarray(v, np.float32) for k, v in th.feature_dicts.items()}
    for bc, has_zero in (("noflux", False), ("periodic", True)):
        te._bc = bc
        s = te._sample(x, edges, th.edge_weight_dicts, (128, 256, 768))
        assert bool(s.pull_mask[0].any()) == has_zero
        assert bool(((s.push_nbr == 0) & (s.push_mask > 0)).any()) == has_zero


def test_ensemble_forward_is_the_member_mean(narrow):
    """A regressor ensemble predicts the member mean; a classifier
    ensemble averages probabilities and returns the mean's logit."""
    _, _, _, th = trajectories()
    x = {k: np.asarray(v, np.float32) for k, v in th.feature_dicts.items()}
    edges = {k: np.asarray(th.edge_index_dicts[et], np.int64)
             for k, et in zip(("push", "pull", "connect"), schema.EDGE_TYPES)}
    caps = (128, 256, 768)
    mask = {"grain": np.ones((caps[0], 1)), "joint": np.ones((caps[1], 1))}
    regs, clss = narrow["port_ens"]

    def forward(reg, cls):
        e = teng.RolloutEngine(reg, cls, device="cpu")
        e._mask, e._bc = mask, "periodic"
        return e._forward(x, edges, th.edge_weight_dicts, caps)[0]

    yr, yc = forward(regs, clss)
    singles = [forward(r, clss[0]) for r in regs]
    for k in yr:
        np.testing.assert_allclose(
            yr[k], np.mean([s[0][k] for s in singles], 0), rtol=1e-5,
            atol=1e-6, err_msg=k)
    cs = [forward(regs[0], c)[1] for c in clss]
    pm = np.clip(np.mean([1 / (1 + np.exp(-c["edge_event"].astype(np.float64)))
                          for c in cs], 0), 1e-7, 1 - 1e-7)
    np.testing.assert_allclose(yc["edge_event"], np.log(pm) - np.log1p(-pm),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(yc["edge"], np.mean([c["edge"] for c in cs], 0),
                               rtol=1e-5, atol=1e-6)


def test_engine_refuses_the_halo_forward(narrow):
    """The halo-partitioned forward takes single models, as in JAX: an
    ensemble under halo is refused."""
    reg, cls = narrow["port"]
    with pytest.raises(ValueError, match="single models"):
        teng.RolloutEngine([reg, reg], cls, device="cpu", halo=(None, 4))


def cli_line(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("jit_editor", [False, True])
def test_cli_without_device_resident_matches_jax(jit_editor):
    """The CLI's default rollout (the host engine) at --platform cpu, one
    span of the JAX package's generate recipe with the shipped
    checkpoints: the JSON keys and events_pred of the JAX CLI."""
    argv = ["--platform", "cpu", "--generate", "--model_dir",
            os.path.join(REPO, "artifacts", "40um"), "--seed", "3", "--G", "4",
            "--R", "1", "--growth_height", str(ONE_SPAN), "--c_threshold",
            "0.9"] + (["--jit_editor"] if jit_editor else [])
    jl = cli_line(jcli.main, argv)
    tl = cli_line(tcli.main, argv)
    assert set(tl) == set(jl)
    for k in ("events_pred", "events_tp", "events_truth", "final_layer_error",
              "mean_layer_error", "KS"):
        assert tl[k] == jl[k], k
    assert tl["inference_time_s"] >= 0
