"""The training half of the port's parallel layer against the JAX
package's, on gloo ranks on the CPU (parallel.mesh.launch) against JAX's
virtual 8-device mesh, from the same weights (JAX's init at layer size 8,
carried by params_from_jax) and the same numpy-seeded graphs:

- the partitioned forward (row blocks, all-gathered tables) of both
  models at D = 4 within 2e-5 (JAX's tests/test_parallel.py);
- one partitioned train step under SGD(lr=1) (the update is the
  gradient: a D-fold overcount would show) at D = 4, both models, and
  the hybrid step at dp = 2 x gp = 2: loss rtol 1e-5, update rtol 2e-4,
  atol 1e-6;
- the halo train step at D = 4 under SGD(1e-2): loss rtol 1e-5, params
  rtol 2e-4, atol 2e-6 (JAX's tests/test_halo.py);
- the data-parallel step at D = 4 (batch 8) against one rank, two Adam
  steps: losses rtol 1e-5, then 1e-3 (JAX's test runs 8 devices);
- the differentiable exchange and all_gather at D = 1, 2 (two sub-group
  axes of a 2 x 2 mesh), 3 and 4 against one process's autograd.

Two rank groups are spawned for the module (4 ranks on a 2 x 2 mesh and
3 ranks on a 3 x 1 mesh); the ranks run tests/torch_rank_jobs.py, which
imports no JAX."""

import concurrent.futures
import copy

import jax
import numpy as np
import optax
import pytest
import torch

from graingraphnn_torch.graph import state as tstate
from graingraphnn_torch.models import hyper as thyper
from graingraphnn_torch.parallel import halo
from graingraphnn_torch.parallel import mesh as tmesh
from graingraphnn_torch.train import checkpoint
from graingraphnn_torch.train import trainer as ttrainer
from graingraphnn_tpu.graph import schema
from graingraphnn_tpu.graph import state as jstate
from graingraphnn_tpu.graph import synthetic
from graingraphnn_tpu.models import grain_nn, hyper
from graingraphnn_tpu.parallel import halo as jhalo
from graingraphnn_tpu.parallel import mesh as jmesh
from graingraphnn_tpu.parallel import partition as jpart
from graingraphnn_tpu.train import trainer as jtrainer
from tests import torch_rank_jobs
from tests.util import synthetic_coo

FWD_TOL = 2e-5
LOSS_RTOL = 1e-5
UPD_RTOL, UPD_ATOL = 2e-4, 1e-6
HALO_RTOL, HALO_ATOL = 2e-4, 2e-6
AXES4 = (("dp", 2), ("gp", 2))
AXES3 = (("a", 3), ("b", 1))


def graph(seed, ng=16, nj=32):
    """tests/util.synthetic_sample's arrays and targets."""
    f, e, w, m = synthetic_coo(ng, nj, seed)
    rng = np.random.default_rng(seed + 1000)
    n_jj = e[schema.EDGE_TYPES[2]].shape[1]
    t = {"grain": rng.uniform(-0.9, 0.9, (ng, 2)).astype(np.float32),
         "joint": rng.uniform(-0.9, 0.9, (nj, 2)).astype(np.float32),
         "grain_event": (rng.uniform(size=ng) < 0.1).astype(np.float32),
         "edge_event": rng.choice([-100.0, 0.0, 1.0], size=n_jj,
                                  p=[0.1, 0.8, 0.1]).astype(np.float32)}
    return f, e, w, m, t


def both(seed):
    """(JAX sample, port sample) of graph(seed)."""
    a = graph(seed)
    return jstate.build_sample(*a), tstate.build_sample(*a, device="cpu")


def flat(tree):
    return {k: np.asarray(v) for k, v in checkpoint._flatten(tree).items()}


def collective_case(D, seed):
    rng = np.random.default_rng(seed)
    r = lambda *s: rng.normal(size=s).astype(np.float32)
    return r(D, 3, 4), r(D, 3, 4), r(D, 3, 4), r(D, D, 3, 4)


def collective_reference(xs, wl, wr, wg):
    """x's gradients of the rank losses summed, in one process."""
    D = len(xs)
    x = [torch.from_numpy(a).requires_grad_(True) for a in xs]
    g = torch.stack(x)
    loss = sum((torch.from_numpy(wl[i]) * x[(i - 1) % D]).sum()
               + (torch.from_numpy(wr[i]) * x[(i + 1) % D]).sum()
               + (torch.from_numpy(wg[i]) * g).sum() for i in range(D))
    loss.backward()
    return [t.grad.numpy() for t in x]


@pytest.fixture(scope="module")
def case():
    """Weights, graphs and hyperparameters of every check."""
    hp_r = hyper.regressor(0, layer_size=8)
    hp_c = hyper.classifier(1, layer_size=8)          # pos_weight 2
    hp_dp = hyper.regressor(0, layer_size=8, batch_size=8)
    rp = grain_nn.init_regressor(jax.random.PRNGKey(0), hp_r)
    cp = grain_nn.init_classifier(jax.random.PRNGKey(1), hp_c)
    thp = {"r": thyper.regressor(0, layer_size=8),
           "c": thyper.classifier(1, layer_size=8),
           "dp": thyper.regressor(0, layer_size=8, batch_size=8)}
    models = {"r": checkpoint.params_from_jax(rp, thp["r"], "cpu"),
              "c": checkpoint.params_from_jax(cp, thp["c"], "cpu")}
    one = both(0)
    batch4 = [both(i) for i in range(4)]
    batch8 = [both(i) for i in range(8)]
    ring = synthetic.spatial_ring_arrays(32, seed=1)
    striped = halo.build_striped(*ring[:4], 4, ring[4])[0]
    return dict(hp_r=hp_r, hp_c=hp_c, hp_dp=hp_dp, rp=rp, cp=cp, thp=thp,
                models=models, one=one,
                jbatch4=jstate.stack([j for j, _ in batch4]),
                tbatch4=tstate.stack([t for _, t in batch4]),
                jbatch8=jstate.stack([j for j, _ in batch8]),
                tbatch8=tstate.stack([t for _, t in batch8]),
                ring=ring, striped=striped)


def _launch(jobs, D, axes, store):
    res = tmesh.launch(torch_rank_jobs.run_jobs, D, list(jobs.values()),
                       device="cpu", threads=1, store_dir=store, axes=axes)
    return [dict(zip(jobs, r)) for r in res]


@pytest.fixture(scope="module")
def ranks(case, tmp_path_factory):
    """{"4": [{key: result} of each rank of the 2 x 2 mesh], "3": [...]
    of the 3 x 1 mesh, "bumped": the launcher's tensor of the bump job}."""
    c = case
    sgd1, sgd2 = ("sgd", 1.0), ("sgd", 1e-2)
    jobs4 = {
        "fwd_r": ("partitioned_forward", (c["models"]["r"], c["one"][1],
                                          None)),
        "fwd_c": ("partitioned_forward", (c["models"]["c"], c["one"][1],
                                          None)),
        "part_r": ("train_steps", ("partitioned", c["models"]["r"],
                                   c["thp"]["r"], c["one"][1], sgd1, 1, {})),
        "part_c": ("train_steps", ("partitioned", c["models"]["c"],
                                   c["thp"]["c"], c["one"][1], sgd1, 1, {})),
        "hybrid_r": ("train_steps", ("hybrid", c["models"]["r"],
                                     c["thp"]["r"], c["tbatch4"], sgd1, 1,
                                     {})),
        "hybrid_c": ("train_steps", ("hybrid", c["models"]["c"],
                                     c["thp"]["c"], c["tbatch4"], sgd1, 1,
                                     {})),
        "halo": ("train_steps", ("halo", c["models"]["r"], c["thp"]["r"],
                                 c["striped"], sgd2, 1, {})),
        "dp": ("train_steps", ("dp", c["models"]["r"], c["thp"]["dp"],
                               c["tbatch8"], ("adam", 1e-3), 2, {})),
    }
    for axis, D in (("gp", 2), ("dp", 2), (None, 4)):
        jobs4[("coll", axis)] = ("collective_grads",
                                 (axis,) + collective_case(D, D))
    jobs3 = {("coll", axis): ("collective_grads",
                              (axis,) + collective_case(D, D + 10))
             for axis, D in ((None, 3), ("b", 1))}
    bumped = torch.zeros(5)
    jobs3["bump"] = ("bump", (bumped,))
    pool = concurrent.futures.ThreadPoolExecutor(2)
    f4 = pool.submit(_launch, jobs4, 4, AXES4,
                     str(tmp_path_factory.mktemp("r4")))
    f3 = pool.submit(_launch, jobs3, 3, AXES3,
                     str(tmp_path_factory.mktemp("r3")))
    pool.shutdown(wait=True)
    return {"4": f4.result(), "3": f3.result(), "bumped": bumped}


def assert_same_on_every_rank(res, key):
    for r in res[1:]:
        for name, v in res[0][key]["params"].items():
            np.testing.assert_array_equal(r[key]["params"][name], v,
                                          err_msg=name)
        assert r[key]["losses"] == res[0][key]["losses"]


def assert_update(port, params0, jax_after, rtol, atol):
    """port's parameters after a step moved from params0 as JAX's did."""
    p0, after = flat(params0), flat(jax_after)
    for name, v in p0.items():
        np.testing.assert_allclose(v - port["params"][name],
                                   v - after[name], rtol=rtol, atol=atol,
                                   err_msg=name)


@pytest.mark.parametrize("model", ["regressor", "classifier"])
def test_partitioned_forward_matches_jax(case, ranks, model):
    """Row blocks on 4 gloo ranks against JAX's shard_map forward on 4
    virtual devices and the one-device forward."""
    params, hp = ((case["rp"], case["hp_r"]) if model == "regressor"
                  else (case["cp"], case["hp_c"]))
    m = jmesh.make_mesh([("gp", 4)], n_devices=4)
    y = jpart.make_partitioned_forward(hp, m, model=model)(params,
                                                           case["one"][0])
    apply = (grain_nn.apply_regressor if model == "regressor"
             else grain_nn.apply_classifier)
    y1 = apply(params, hp, case["one"][0])
    key = "fwd_r" if model == "regressor" else "fwd_c"
    for r in ranks["4"]:
        out = r[key]
        assert set(out) == set(y)
        for k in y:
            np.testing.assert_allclose(out[k], np.asarray(y[k]),
                                       rtol=FWD_TOL, atol=FWD_TOL, err_msg=k)
            np.testing.assert_allclose(out[k], np.asarray(y1[k]),
                                       rtol=FWD_TOL, atol=FWD_TOL, err_msg=k)


@pytest.mark.parametrize("model", ["regressor", "classifier"])
def test_partitioned_train_step_matches_jax(case, ranks, model):
    """SGD(lr=1) on one graph split over 4 ranks against JAX's
    partitioned step: the loss, and the update (the gradient) with no
    D-fold overcount; every rank ends with the same parameters."""
    params, hp, key = ((case["rp"], case["hp_r"], "part_r")
                       if model == "regressor"
                       else (case["cp"], case["hp_c"], "part_c"))
    tx = optax.sgd(1.0)
    m = jmesh.make_mesh([("gp", 4)], n_devices=4)
    p2, _, l2 = jpart.make_partitioned_train_step(hp, tx, m)(
        params, tx.init(params), case["one"][0])
    port = ranks["4"][0][key]
    np.testing.assert_allclose(port["losses"][0], float(l2), rtol=LOSS_RTOL)
    assert_update(port, params, p2, UPD_RTOL, UPD_ATOL)
    assert_same_on_every_rank(ranks["4"], key)


@pytest.mark.parametrize("model", ["regressor", "classifier"])
def test_hybrid_train_step_matches_jax(case, ranks, model):
    """dp = 2 x gp = 2 on a batch of 4 against JAX's hybrid step on a
    (dp, gp) = (2, 2) mesh under SGD(lr=1)."""
    params, hp, key = ((case["rp"], case["hp_r"], "hybrid_r")
                       if model == "regressor"
                       else (case["cp"], case["hp_c"], "hybrid_c"))
    tx = optax.sgd(1.0)
    m = jmesh.make_mesh([("dp", 2), ("gp", 2)], n_devices=4)
    p2, _, l2 = jpart.make_hybrid_train_step(hp, tx, m)(
        params, tx.init(params), case["jbatch4"])
    port = ranks["4"][0][key]
    np.testing.assert_allclose(port["losses"][0], float(l2), rtol=LOSS_RTOL)
    assert_update(port, params, p2, UPD_RTOL, UPD_ATOL)
    assert_same_on_every_rank(ranks["4"], key)


def test_halo_train_step_matches_jax(case, ranks):
    """One SGD(1e-2) step on a 32-grain graph in 4 stripes against JAX's
    halo step: boundary-node gradients reach the stripes that own them."""
    params, hp = case["rp"], case["hp_r"]
    tx = optax.sgd(1e-2)
    ring = case["ring"]
    striped, _ = jhalo.build_striped(*ring[:4], 4, ring[4])
    m = jmesh.make_mesh([("gp", 4)], n_devices=4)
    p2, _, l2 = jhalo.make_halo_train_step(hp, tx, m)(
        params, tx.init(params), striped)
    port = ranks["4"][0]["halo"]
    np.testing.assert_allclose(port["losses"][0], float(l2), rtol=LOSS_RTOL)
    after = flat(p2)
    for name, v in after.items():
        np.testing.assert_allclose(port["params"][name], v, rtol=HALO_RTOL,
                                   atol=HALO_ATOL, err_msg=name)
    assert_same_on_every_rank(ranks["4"], "halo")
    assert port["bytes"][0] > 0


def test_dp_train_step_matches_one_rank_and_jax(case, ranks):
    """Two Adam(1e-3) steps on a batch of 8 over 4 ranks against the
    port's one-rank step and JAX's single-device step."""
    hp, params = case["hp_dp"], case["rp"]
    tx = optax.adam(1e-3)
    single = jtrainer.make_train_step(hp, tx)
    p1, o1, l1 = single(params, tx.init(params), case["jbatch8"])
    _, _, l1b = single(p1, o1, case["jbatch8"])

    model = copy.deepcopy(case["models"]["r"])
    opt = torch.optim.Adam(model.parameters(), lr=1e-3, betas=(0.9, 0.999),
                           eps=1e-8)
    sched = torch.optim.lr_scheduler.StepLR(opt, step_size=1 << 30)
    step = ttrainer.make_train_step(case["thp"]["dp"], model, opt, sched)
    packed = tstate.pack(case["tbatch8"])
    t1, t1b = float(step(packed)), float(step(packed))

    port = ranks["4"][0]["dp"]["losses"]
    for ref in ((float(l1), float(l1b)), (t1, t1b)):
        np.testing.assert_allclose(port[0], ref[0], rtol=1e-5)
        np.testing.assert_allclose(port[1], ref[1], rtol=1e-3)
    assert port[1] < port[0]
    assert_same_on_every_rank(ranks["4"], "dp")


@pytest.mark.parametrize("group,axis,D", [("4", "gp", 2), ("4", "dp", 2),
                                          ("4", None, 4), ("3", None, 3),
                                          ("3", "b", 1)])
def test_differentiable_collectives(ranks, group, axis, D):
    """exchange and all_gather along an axis (a sub-group of the mesh, or
    the whole group): values, and each rank's gradient equal to one
    process's autograd of the summed rank losses (D = 1 on gloo returns x
    itself twice)."""
    xs, wl, wr, wg = collective_case(D, D + (10 if group == "3" else 0))
    ref = collective_reference(xs, wl, wr, wg)
    axes = AXES4 if group == "4" else AXES3
    for rank, res in enumerate(ranks[group]):
        out = res[("coll", axis)]
        line = (tmesh._line(rank, axes, [a for a, _ in axes].index(axis))
                if axis else list(range(len(ranks[group]))))
        i = line.index(rank)
        np.testing.assert_array_equal(out["left"], xs[(i - 1) % D])
        np.testing.assert_array_equal(out["right"], xs[(i + 1) % D])
        np.testing.assert_array_equal(out["gather"], xs)
        np.testing.assert_allclose(out["grad"], ref[i], rtol=1e-6,
                                   atol=1e-6)


def test_launch_gives_each_rank_its_own_args(ranks):
    """A tensor passed to launch is copied to every rank: a rank's in-place
    add reaches neither the other ranks nor the launcher (shared storage
    would let D ranks step one model D times)."""
    for res in ranks["3"]:
        np.testing.assert_array_equal(res["bump"], np.ones(5, np.float32))
    np.testing.assert_array_equal(ranks["bumped"].numpy(), np.zeros(5))


def test_mesh_layout_is_row_major():
    """Rank r of a (dp, gp) mesh sits at dp r // gp, gp r % gp, as JAX's
    make_mesh places devices; sub-group lines and bad axes."""
    axes = tmesh.check_axes(8, [("dp", 2), ("gp", 4)])
    for r in range(8):
        assert tmesh._coords(r, axes) == [r // 4, r % 4]
    assert tmesh._line(5, axes, 1) == [4, 5, 6, 7]
    assert tmesh._line(5, axes, 0) == [1, 5]
    jm = jmesh.make_mesh([("dp", 2), ("gp", 4)], n_devices=8)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    assert ids.tolist() == [[0, 1, 2, 3], [4, 5, 6, 7]]
    with pytest.raises(ValueError, match="multiply"):
        tmesh.check_axes(4, [("dp", 3)])
    mesh = tmesh.Mesh(D=4, rank=3, backend="gloo",
                      device=torch.device("cpu"), axes=AXES4)
    assert (mesh.index("dp"), mesh.index("gp"), mesh.index()) == (1, 1, 3)
    assert mesh.peers("gp") == [2, 3] and mesh.peers() == [0, 1, 2, 3]
    with pytest.raises(ValueError, match="no axis"):
        mesh.index("tp")
