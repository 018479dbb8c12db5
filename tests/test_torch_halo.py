"""The port's halo stripes (parallel.halo) against the JAX package's:
build_striped bit-equal at D = 2, 4 and 8 on a synthetic microstructure
with training targets; the striped forward of both models on gloo ranks
(parallel.mesh.launch, D = 2 and 4, on the CPU) within rtol = atol =
2e-5 of JAX's make_halo_forward on the virtual 8-device mesh, the
tolerance of JAX's own tests/test_halo.py; its refusals; and the host
engine with halo=(mesh, 2) against the port's own one-device engine on
the 40 um generate-mode graph. Each rank group is spawned once for the
module; the ranks import no JAX (tests/torch_rank_jobs.py)."""

import jax
import numpy as np
import pytest

from graingraphnn_torch.models import hyper as thyper
from graingraphnn_torch.parallel import halo
from graingraphnn_torch.parallel import mesh as tmesh
from graingraphnn_torch.train import checkpoint
from graingraphnn_tpu.graph import synthetic
from graingraphnn_tpu.models import grain_nn, hyper
from graingraphnn_tpu.parallel import halo as jhalo
from graingraphnn_tpu.parallel import mesh as jmesh
from tests import torch_rank_jobs
from tests.test_torch_fixture import jax_start

TOL = 2e-5
FIELDS = ("grain_x", "joint_x", "grain_mask", "joint_mask", "push_nbr",
          "push_len", "push_mask", "connect_nbr", "connect_len",
          "connect_mask", "pull_nbr", "pull_len", "pull_mask", "jj_src",
          "jj_dst", "jj_len", "jj_mask", "y_grain", "y_joint",
          "y_edge_event", "y_grain_event", "n_grain_rows", "n_joint_rows",
          "n_jj_rows")
ENGINE_RECIPE = (40, 3, 4.0, 1.0)


def graph_args(arrays):
    feats, ei, ew, masks, _t = arrays
    return (feats, ei, ew, masks)


@pytest.fixture(scope="module")
def models():
    """Random-init JAX regressor (with the edge-length head) and transfer
    classifier at width 8, and the port's models holding their weights."""
    hp_r = hyper.regressor(0, layer_size=8, edge_len=True)
    hp_c = hyper.classifier_transfered(1, layer_size=8)
    rp = grain_nn.init_regressor(jax.random.PRNGKey(0), hp_r)
    cp = grain_nn.init_classifier(jax.random.PRNGKey(1), hp_c,
                                  regressor_params=rp)
    reg = checkpoint.params_from_jax(
        rp, thyper.regressor(0, layer_size=8, edge_len=True), "cpu")
    cls = checkpoint.params_from_jax(
        cp, thyper.classifier_transfered(1, layer_size=8), "cpu")
    return (rp, hp_r, cp, hp_c), (reg, cls)


@pytest.fixture(scope="module")
def graphs():
    _traj, hg0 = jax_start(40, 3, 4.0, 1.0)
    g40 = ({k: np.asarray(v) for k, v in hg0.feature_dicts.items()},
           {k: np.asarray(v) for k, v in hg0.edge_index_dicts.items()},
           {k: np.asarray(v) for k, v in hg0.edge_weight_dicts.items()},
           {k: np.asarray(v) for k, v in hg0.mask.items()})
    return {"brick": graph_args(synthetic.brick_wall_arrays(ng=128, seed=3)),
            "g40": g40}


def _jobs(models, graphs, D):
    """{key: (job, args)} of a group of D ranks."""
    reg, cls = models[1]
    jobs = {(m, g): ("halo_forward", (model, graphs[g], D))
            for g in (("brick", "g40") if D == 2 else ("brick",))
            for m, model in (("regressor", reg), ("classifier", cls))}
    jobs["exchange"] = ("exchange_bytes", ())
    jobs["collectives"] = ("collectives", (torch_rank_jobs.COLLECTIVE_X,))
    if D == 2:
        jobs["engine"] = ("engine_halo", (
            reg, cls, ENGINE_RECIPE, {"c_threshold": 0.6, "seed": 3,
                                      "growth_height": 14.4,
                                      "compare": False}))
    return jobs


@pytest.fixture(scope="module")
def ranks(models, graphs, tmp_path_factory):
    """{D: [{key: result} of each rank]}: every rank job of the module, on
    groups of 2 and 4 gloo ranks."""
    out = {}
    for D in (2, 4):
        jobs = _jobs(models, graphs, D)
        res = tmesh.launch(torch_rank_jobs.run_jobs, D, list(jobs.values()),
                           device="cpu", threads=1,
                           store_dir=str(tmp_path_factory.mktemp(f"d{D}")))
        out[D] = [dict(zip(jobs, r)) for r in res]
    return out


@pytest.mark.parametrize("D", [2, 4, 8])
def test_build_striped_matches_jax(D):
    feats, ei, ew, masks, targets = synthetic.spatial_ring_arrays(ng=160,
                                                                  seed=D)
    js, jmeta = jhalo.build_striped(feats, ei, ew, masks, D, targets)
    ts, meta = halo.build_striped(feats, ei, ew, masks, D, targets)
    for f in FIELDS:
        a, b = getattr(ts, f).numpy(), np.asarray(getattr(js, f))
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    for f in ("grain_perm", "joint_perm", "grain_cap", "joint_cap", "jj_cap",
              "jj_map"):
        np.testing.assert_array_equal(getattr(meta, f), getattr(jmeta, f),
                                      err_msg=f)
    assert meta.stripe_sizes == jmeta.stripe_sizes
    out = np.arange(D * meta.joint_cap, dtype=np.float32)
    np.testing.assert_array_equal(meta.scatter_back(out, "joint"),
                                  jmeta.scatter_back(out, "joint")[:, 0])


def test_build_striped_refusals(graphs):
    """Too many stripes for the interaction range, and capacities below
    the largest stripe, raise as in JAX."""
    g = graphs["g40"]
    for fn in (halo.build_striped, jhalo.build_striped):
        with pytest.raises(ValueError, match="non-adjacent"):
            fn(*g, 16)
        with pytest.raises(ValueError, match="stripe capacity"):
            fn(*g, 2, grain_cap=8)
        with pytest.raises(ValueError, match="jj stripe capacity"):
            fn(*g, 2, jj_cap=8)


@pytest.mark.parametrize("D,graph", [(2, "brick"), (2, "g40"),
                                     (4, "brick")])
def test_halo_forward_matches_jax(models, graphs, ranks, D, graph):
    """The striped forward on D gloo ranks against JAX's make_halo_forward
    on D virtual devices, both models."""
    (rp, hp_r, cp, hp_c), _ = models
    mesh = jmesh.make_mesh([("gp", D)], n_devices=D)
    striped, meta = jhalo.build_striped(*graphs[graph], D)
    for params, hp, model in ((rp, hp_r, "regressor"),
                              (cp, hp_c, "classifier")):
        y = jhalo.make_halo_forward(hp, mesh, model=model)(params, striped)
        port = ranks[D][0][(model, graph)]
        for key, v in y.items():
            ref = (meta.scatter_back_jj(np.asarray(v)) if key in
                   ("edge", "edge_event") else meta.scatter_back(
                       np.asarray(v), "joint" if key == "joint" else "grain"))
            np.testing.assert_allclose(port[key], ref.reshape(
                port[key].shape), rtol=TOL, atol=TOL, err_msg=key)


def test_ranks_agree_and_exchange(ranks):
    """Every rank holds the same gathered outputs, and each forward
    exchanged its tables: per model, 2 cells x 2 source tables per layer
    and one table for the jj heads."""
    for D, res in ranks.items():
        for key, out in res[0].items():
            if isinstance(key, tuple):
                for r in range(1, D):
                    for k in out:
                        np.testing.assert_array_equal(out[k], res[r][key][k])
        n_forwards = sum(isinstance(k, tuple) for k in res[0])
        n_bytes, n_ex = res[0]["exchange"]
        assert n_ex == n_forwards * (2 * 2 + 1) and n_bytes > 0


def test_collectives_on_gloo_ranks(ranks):
    """The exchange, all_reduce (sum, max, bool max) and all_gather give
    every rank its neighbours' and the group's values, over gloo."""
    for D, res in ranks.items():
        for r, want in enumerate(torch_rank_jobs.expected_collectives(D)):
            got = res[r]["collectives"]
            assert got["backend"] == "gloo" and got["device"] == "cpu"
            assert got["bytes"] > 0
            for k, v in want.items():
                np.testing.assert_array_equal(got[k], v, err_msg=f"{D} {k}")


def test_engine_halo_matches_one_device(models, ranks):
    """RolloutEngine(halo=(mesh, 2)) rolls the 40 um graph out as the
    port's one-device engine does: the same events, live grains and
    volumes' misorientation."""
    from graingraphnn_torch.data import extraction as textraction
    from graingraphnn_torch.rollout.engine import RolloutEngine

    reg, cls = models[1]
    traj = textraction.generate(*ENGINE_RECIPE)
    hg0 = textraction.make_test_sample(traj, span=6)
    one = RolloutEngine(reg, cls, c_threshold=0.6, seed=3,
                        device="cpu").run(hg0, traj, growth_height=14.4,
                                          compare=False)
    part = ranks[2][0]["engine"]
    assert part["events_pred"] == one["events_pred"]
    assert part["num_grains_live"] == one["num_grains_live"]
    np.testing.assert_allclose(part["misorientation"],
                               one["misorientation"], rtol=1e-4, atol=1e-5)
    assert ranks[2][1]["engine"]["events_pred"] == part["events_pred"]
