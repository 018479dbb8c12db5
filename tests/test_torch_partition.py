"""The port's partitioned rollout (parallel.partitioned_rollout, with the
sharded editor of parallel.sharded_editor) on four gloo ranks on the CPU,
against the JAX package's on four virtual devices, from the same state:
the 128-grain synthetic brick wall of JAX's
test_composed_rollout_workset_retry_from_tiny, its random-init models
(logits spread by 8) and its threshold, the working set started at 16 so
the span's edit is sized up and run again. Integer state, events and
retries are bit-equal, positions within 2e-5 (JAX's own
tests/test_partitioned_rollout.py). The sharded edit is held to JAX's at
the grown and at the floor width; the port's partitioned spans to its own
one-device spans; `cli.test --partition 2 --platform cpu --generate` runs
end to end. The rank group is spawned once for the module."""

import concurrent.futures
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graingraphnn_torch.cli import test as test_cli
from graingraphnn_torch.models import hyper as thyper
from graingraphnn_torch.parallel import mesh as tmesh
from graingraphnn_torch.rollout import device_driver as tdd
from graingraphnn_torch.rollout import device_rollout as tdr
from graingraphnn_torch.train import checkpoint
from graingraphnn_tpu.graph import schema, synthetic
from graingraphnn_tpu.models import grain_nn, hyper
from graingraphnn_tpu.parallel import mesh as jmesh
from graingraphnn_tpu.parallel import partitioned_rollout as jpr
from graingraphnn_tpu.rollout import device_rollout as jdr
from graingraphnn_tpu.rollout import topology_jit as jtj

D = 4
POS_ATOL = 2e-5
INTS = ("E_pp", "E_pq", "mask_g", "mask_j", "n_pp")
STATE = ("xg", "xj", "E_pp", "E_pq", "mask_g", "mask_j", "n_pp",
         "pull_cols", "push_cols", "connect_cols")
CLI = ["--generate", "--model_dir", "artifacts/40um", "--seed", "3",
       "--G", "4", "--R", "1", "--eval_every", "5", "--platform", "cpu"]


def _np_state(st):
    return {k: None if getattr(st, k) is None else np.array(getattr(st, k))
            for k in STATE}


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """JAX's retry-from-tiny case: the state, both packages' models, the
    threshold, the first span's edit inputs, JAX's one partitioned span
    from a working set of 16, and the port's rank jobs (run meanwhile on
    D gloo ranks, a future)."""
    feats, ei, _ew, masks, _ = synthetic.brick_wall_arrays(ng=128, seed=3)
    x = {"grain": feats["grain"], "joint": feats["joint"]}
    edges = {"pull": np.asarray(ei[schema.EDGE_TYPES[1]], np.int64),
             "connect": np.asarray(ei[schema.EDGE_TYPES[2]], np.int64)}
    mask = {"grain": masks["grain"].reshape(-1).astype(np.int64),
            "joint": masks["joint"].reshape(-1).astype(np.int64)}
    st0 = jdr.init_device_state(x, edges, mask)
    hp_r = hyper.regressor(0, layer_size=16)
    hp_c = hyper.classifier_transfered(1, layer_size=16)
    rp = grain_nn.init_regressor(jax.random.PRNGKey(0), hp_r)
    cp = grain_nn.init_classifier(jax.random.PRNGKey(1), hp_c,
                                  regressor_params=rp)
    cp = dict(cp)
    cp["lin2"] = {"w": cp["lin2"]["w"] * 8.0, "b": cp["lin2"]["b"]}
    y_c = jax.jit(lambda s: grain_nn.apply_classifier(
        cp, hp_c, jdr.make_sample(s)[0]))(st0)
    Epp = np.asarray(st0.E_pp)
    cand = (Epp[0] < Epp[1]) & (Epp[0] >= 0)
    lgs = np.sort(np.asarray(y_c["edge_event"])[cand])[::-1]
    gaps = lgs[:5] - lgs[1:6]
    k = int(np.argmax(gaps))
    ct = float(jax.nn.sigmoid((lgs[k] + lgs[k + 1]) / 2))
    models = (checkpoint.params_from_jax(
        rp, thyper.regressor(0, layer_size=16), "cpu"),
        checkpoint.params_from_jax(
            cp, thyper.classifier_transfered(1, layer_size=16), "cpu"))
    edit = edit_inputs(rp, hp_r, cp, hp_c, st0, ct)
    pool = concurrent.futures.ThreadPoolExecutor(1)
    ranks = pool.submit(rank_jobs, models, st0, ct, edit,
                        str(tmp_path_factory.mktemp("ranks")))
    pool.shutdown(wait=False)

    mesh = jmesh.make_mesh([("gp", D)], n_devices=D)
    roll = jpr.PartitionedRollout(rp, hp_r, cp, hp_c, mesh, span=6,
                                  c_threshold=ct, wq=16, wp=16)
    st1, aux = roll.run(st0, 1)
    return dict(st0=st0, ct=ct, roll=roll, st1=st1, aux=aux, models=models,
                edit=edit, ranks=ranks)


def edit_inputs(rp, hp_r, cp, hp_c, st, ct):
    """The first span's edit inputs (JAX's forward) as numpy, as the
    sharded editor takes them."""
    @jax.jit
    def inputs(st):
        _s, y_r, y_c, _ = jdr.forward_stage(rp, hp_r, cp, hp_c, st,
                                            jtj.RING_MAX)
        _xg, xj = jdr.integrate_stage(st, y_r["joint"], y_r["grain"], 6)
        ge, _ = jdr.elim_candidates(st, y_r["grain_area"], 1e-4)
        logits = jnp.where(st.E_pp[0] >= 0, y_c["edge_event"], jdr.NEG)
        return xj, y_r, ge, logits

    xj, y_r, ge, logits = inputs(st)
    return {"E_pp": np.asarray(st.E_pp), "E_pq": np.asarray(st.E_pq),
            "logits": np.asarray(logits, np.float32), "xj": np.asarray(xj),
            "y_joint": np.asarray(y_r["joint"]),
            "mask_g": np.asarray(st.mask_g), "mask_j": np.asarray(st.mask_j),
            "n_pp": np.asarray(st.n_pp), "ge": np.asarray(ge),
            "y_grain": np.asarray(y_r["grain"]),
            "threshold": np.float32(ct)}


def rank_jobs(models, st0, ct, edit, store_dir):
    """[{key: result} of each rank]: the module's jobs on D gloo ranks."""
    from tests import torch_rank_jobs

    kw = dict(span=6, c_threshold=ct, wq=16, wp=16)
    reg, cls = models
    jobs = {
        "spans3": ("partitioned_run", (reg, cls, _np_state(st0), 3, kw)),
        "span": ("partitioned_run", (reg, cls, _np_state(st0), 1, kw)),
        "edit_grown": ("sharded_edit", (edit, "grown", None, None)),
        "edit_floor": ("sharded_edit", (edit, 128, 128, 3)),
    }
    res = tmesh.launch(torch_rank_jobs.run_jobs, D, list(jobs.values()),
                       device="cpu", threads=1, store_dir=store_dir)
    return [dict(zip(jobs, r)) for r in res]


@pytest.fixture(scope="module")
def edit(case):
    return case["edit"]


@pytest.fixture(scope="module")
def ranks(case):
    return case["ranks"].result()


def assert_state(st, ref, aux=None, aux_ref=None):
    for k in INTS + ("pull_cols", "push_cols", "connect_cols"):
        a, b = st[k], ref[k]
        assert (a is None) == (b is None), k
        if a is not None:
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=k)
    for k in ("xg", "xj"):
        np.testing.assert_allclose(st[k], np.asarray(ref[k]), rtol=0,
                                   atol=POS_ATOL, err_msg=k)
    if aux is not None:
        for k in ("grain_events", "extra_events", "switching",
                  "editor_retries", "elim_saturated"):
            np.testing.assert_array_equal(np.asarray(aux[k]),
                                          np.asarray(aux_ref[k]), err_msg=k)


def test_partitioned_span_matches_jax(case, ranks):
    """One span from the same state, the working set sized up from 16:
    JAX's retries, events and state."""
    st, aux, (floor, grown) = ranks[0]["span"]
    assert floor == case["roll"]._wp // 2 ** int(case["aux"]
                                                 ["editor_retries"][0])
    assert aux["editor_retries"][0] > 0 and grown > floor
    assert grown == case["roll"]._wp
    assert_state(st, _np_state(case["st1"]), aux, case["aux"])
    n_switch = int((aux["switching"][0][:, 0] >= 0).sum())
    assert n_switch >= 1
    for r in range(1, D):
        other, aux_r, _ = ranks[r]["span"]
        for k in STATE:
            if other[k] is not None:
                np.testing.assert_array_equal(other[k], st[k], err_msg=k)


@pytest.mark.parametrize("width", ["grown", "floor"])
def test_sharded_edit_matches_jax(case, edit, ranks, width):
    """The sharded edit on D ranks against JAX's sharded editor on D
    virtual devices at the same working set: every output bit-equal, the
    `invalid` flag included (the floor width is too small for the span);
    at the grown width both equal the full editor's update_jit."""
    roll = case["roll"]
    wq, wp, rounds = ((roll._wq, roll._wp, roll.rounds) if width == "grown"
                      else (128, 128, 3))
    f = roll._editor(wq, wp, rounds)
    ref = f(*(jnp.asarray(edit[k]) for k in (
        "E_pp", "E_pq", "logits", "xj", "y_joint", "mask_g", "mask_j",
        "n_pp", "ge", "y_grain")), jnp.float32(edit["threshold"]))
    out = ranks[0][f"edit_{width}"]
    assert out["invalid"] == bool(ref[8])
    for name, a in zip(("E_pp", "E_pq", "xj", "mask_g", "mask_j", "n_pp",
                        "switching", "extra"), ref[:8]):
        np.testing.assert_array_equal(out[name], np.asarray(a),
                                      err_msg=name)
    if width == "grown":
        assert not out["invalid"]
        NG = edit["mask_g"].shape[0]
        full, sw, ex = jtj.update_jit(
            jtj.TopoState(E_pp=jnp.asarray(edit["E_pp"]),
                          E_pq=jnp.asarray(edit["E_pq"]),
                          xj=jnp.asarray(edit["xj"]),
                          y_joint=jnp.asarray(edit["y_joint"]),
                          mask_g=jnp.asarray(edit["mask_g"]),
                          mask_j=jnp.asarray(edit["mask_j"]),
                          append_ptr=jnp.asarray(edit["n_pp"])),
            jnp.asarray(edit["logits"]), jnp.asarray(edit["ge"]),
            jnp.asarray(edit["y_grain"]), jnp.float32(edit["threshold"]),
            NG)
        np.testing.assert_array_equal(out["E_pp"], np.asarray(full.E_pp))
        np.testing.assert_array_equal(out["mask_g"], np.asarray(full.mask_g))
        np.testing.assert_array_equal(out["extra"], np.asarray(ex))


def test_partitioned_spans_match_port_one_device(case, ranks):
    """Port against port: three partitioned spans against the port's own
    one-device rollout from the same state."""
    reg, cls = case["models"]
    st0 = tdr.DeviceRolloutState(**{
        k: None if v is None else torch.from_numpy(v)
        for k, v in _np_state(case["st0"]).items()})
    with torch.no_grad():
        st_ref, aux_ref = tdr.make_rollout(
            reg, cls, n_steps=3, span=6, c_threshold=case["ct"])(st0)
    st, aux, _ = ranks[0]["spans3"]
    assert_state(st, _np_state(st_ref), aux, {
        k: v.numpy() if isinstance(v, torch.Tensor) else v
        for k, v in aux_ref.items()} | {"editor_retries":
                                        aux["editor_retries"]})


def test_cli_partition_runs(capsys, tmp_path, monkeypatch):
    """cli.test --partition 2 on the CPU: the JAX package's generate recipe
    (40 um, seed 3) on two gloo ranks, its JSON line the one-device
    device-resident run's."""
    monkeypatch.chdir(tmp_path)
    repo = __import__("os").path.dirname(__import__("os").path.dirname(
        __import__("os").path.abspath(__file__)))
    argv = [a if a != "artifacts/40um" else f"{repo}/artifacts/40um"
            for a in CLI]
    test_cli.main(argv + ["--partition", "2", "--growth_height", "14.4"])
    part = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    test_cli.main(argv + ["--device_resident", "--growth_height", "14.4"])
    one = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k in ("events_pred", "events_tp", "events_truth"):
        assert part[k] == one[k], k
    assert part["events_pred"] > 0


def test_partition_refusals():
    """Nucleation and the moving melt pool stay on the one-device rollout,
    and a partitioned run needs the ranks of a launch."""
    with pytest.raises(SystemExit):
        test_cli.main(CLI + ["--partition", "2", "--nucleation_density",
                             "2e-4"])
    with pytest.raises(SystemExit):
        test_cli.main(CLI + ["--partition", "2", "--meltpool", "cylinder"])
    with pytest.raises(ValueError, match="ranks of parallel.mesh.launch"):
        tdd.run_device_resident(None, None, None, partition=2, device="cpu")
