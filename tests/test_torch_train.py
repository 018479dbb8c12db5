"""The port's training path against the JAX package on the CPU: both losses,
the loss and gradients of a packed batch against jax.value_and_grad of
make_loss_fn, Adam with the staircase schedule and the transfer groups fed
JAX's own gradients, the shuffle order, checkpoints written by the port and
read by JAX, the CLI, G,R jitter and the kernel wrapper's refusal under
autograd. Inputs are tests.util graphs (numpy, from seeds); weights are the
shipped checkpoints or JAX initialisers, carried over with
params_from_jax."""

import dataclasses
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from graingraphnn_torch.data.dataset import GraphDataset
from graingraphnn_torch.graph import state, synthetic
from graingraphnn_torch.kernels import edge_stage
from graingraphnn_torch.models import grain_nn, hyper
from graingraphnn_torch.ops import period_conv
from graingraphnn_torch.train import checkpoint, trainer
from graingraphnn_torch.train import loss as loss_mod
from graingraphnn_tpu.data.dataset import GraphDataset as JGraphDataset
from graingraphnn_tpu.graph import state as jstate
from graingraphnn_tpu.models import grain_nn as jgn
from graingraphnn_tpu.models import hyper as jhyper
from graingraphnn_tpu.train import checkpoint as jck
from graingraphnn_tpu.train import loss as jloss
from graingraphnn_tpu.train import trainer as jtrainer
from tests.test_torch_models_train import CAPS, to_port
from tests.util import synthetic_coo

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LOSS_RTOL = 1e-5
GRAD_ATOL, GRAD_RTOL = 1e-6, 1e-4
PARAM_ATOL = 1e-6


def jax_sample(seed, edge_targets=True):
    """A tests.util graph at CAPS with every target, the edge-length ones
    included (labels on live jj edges, as extraction gives them)."""
    f, e, w, m = synthetic_coo(16, 32, seed)
    rng = np.random.default_rng(seed + 1000)
    n_jj = 96
    targets = {
        "grain": rng.uniform(-0.9, 0.9, (16, 2)).astype(np.float32),
        "joint": rng.uniform(-0.9, 0.9, (32, 2)).astype(np.float32),
        "grain_event": (rng.uniform(size=16) < 0.1).astype(np.float32),
        "edge_event": rng.choice([-100.0, 0.0, 1.0], size=n_jj,
                                 p=[0.1, 0.8, 0.1]).astype(np.float32),
    }
    if edge_targets:
        targets["edge"] = rng.uniform(-0.5, 0.5, n_jj).astype(np.float32)
        targets["edge_mask"] = (rng.uniform(size=n_jj) < 0.8).astype(np.float32)
    return jstate.build_sample(f, e, w, m, targets, **CAPS)


def batch_pair(B, seed=0):
    js = [jax_sample(seed + s) for s in range(B)]
    return jstate.stack(js), state.pack(state.stack([to_port(s) for s in js]))


def port_hp(hp):
    return hyper.HyperParams(**dataclasses.asdict(hp))


def flat_np(tree):
    return {k: np.asarray(v) for k, v in checkpoint._flatten(tree).items()}


CONFIGS = {
    # the shipped configs (artifacts/40um/*.json) at full width
    "regressor0": None,
    "classifier1": None,
    # the deferred options at width 16, with JAX-initialised weights
    "layers2": {"layers": 2},
    "history": {"history": True},
    "edge_len": {"edge_len": True},
}


def config(name):
    """(JAX hp, JAX-initialised params) of a CONFIGS entry."""
    if CONFIGS[name] is None:
        _, hp, _ = jck.load(os.path.join(REPO, "artifacts", "40um", name))
    else:
        hp = jhyper.regressor(0, layer_size=16, **CONFIGS[name])
    init = (jgn.init_regressor if hp.model_type == "regressor"
            else jgn.init_classifier)
    return hp, init(jax.random.PRNGKey(5), hp)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


def _pred(rng, js):
    NG, NJ, E = js.grain_x.shape[0], js.joint_x.shape[0], js.jj_src.shape[0]
    return {"joint": rng.uniform(-1, 1, (NJ, 2)).astype(np.float32),
            "grain": rng.uniform(-1, 1, (NG, 2)).astype(np.float32),
            "edge": rng.uniform(-1, 1, E).astype(np.float32),
            "edge_event": rng.normal(0, 2, E).astype(np.float32)}


@pytest.mark.parametrize("edge_len", [False, True])
def test_regressor_loss_matches_jax(edge_len):
    js = jax_sample(2)
    pred = _pred(np.random.default_rng(2), js)
    ref = jloss.regressor_loss({k: jnp.asarray(v) for k, v in pred.items()},
                               js, edge_len=edge_len)
    out = loss_mod.regressor_loss({k: torch.from_numpy(v) for k, v in pred.items()},
                                  to_port(js), edge_len=edge_len)
    assert out.shape == (1,)
    np.testing.assert_allclose(out.numpy()[0], float(ref), rtol=LOSS_RTOL)


@pytest.mark.parametrize("pos_weight", [1.0, 4.0])
def test_classifier_loss_matches_jax(pos_weight):
    js = jax_sample(3)
    pred = _pred(np.random.default_rng(3), js)
    ref = jloss.classifier_loss({"edge_event": jnp.asarray(pred["edge_event"])},
                                js, pos_weight=pos_weight)
    out = loss_mod.classifier_loss(
        {"edge_event": torch.from_numpy(pred["edge_event"])}, to_port(js),
        pos_weight=pos_weight)
    np.testing.assert_allclose(out.numpy()[0], float(ref), rtol=LOSS_RTOL)


def test_packed_losses_are_per_sample():
    """Each sample's loss in a packed batch equals its loss alone (its own
    row counts as denominators), and batched() is their mean."""
    js = [jax_sample(s) for s in range(3)]
    rng = np.random.default_rng(4)
    preds = [_pred(rng, s) for s in js]
    packed = state.pack(state.stack([to_port(s) for s in js]))
    pred = {k: torch.from_numpy(np.concatenate([p[k] for p in preds]))
            for k in preds[0]}
    for fn, kw in ((loss_mod.regressor_loss, {"edge_len": True}),
                   (loss_mod.classifier_loss, {"pos_weight": 4.0})):
        per = fn(pred, packed, **kw)
        alone = torch.cat([fn({k: torch.from_numpy(v) for k, v in p.items()},
                              to_port(s), **kw) for p, s in zip(preds, js)])
        torch.testing.assert_close(per, alone, rtol=1e-6, atol=0)
        torch.testing.assert_close(loss_mod.batched(fn)(pred, packed, **kw),
                                   alone.mean(), rtol=1e-6, atol=0)


# ---------------------------------------------------------------------------
# loss and gradients of a packed batch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_packed_batch_loss_and_grads_match_jax(name):
    """B=4: the port's loss and every parameter's gradient, through the
    torch formulation under autograd, against jax.value_and_grad of JAX's
    make_loss_fn on the stacked batch."""
    hp, params = config(name)
    jb, tb = batch_pair(4, seed=10)
    lval, grads = jax.jit(jax.value_and_grad(jtrainer.make_loss_fn(hp)))(
        params, jb)
    model = checkpoint.params_from_jax(params, port_hp(hp), device="cpu")
    out, _ = trainer.make_loss_fn(port_hp(hp))(model, tb, kernels=False)
    out.backward()
    np.testing.assert_allclose(float(out.detach()), float(lval), rtol=LOSS_RTOL)
    check_grads(model, grads, GRAD_ATOL, GRAD_RTOL)


def check_grads(model, grads, atol, rtol):
    ref = flat_np(grads)
    assert sorted(ref) == sorted(k for k, _ in model.named_parameters())
    for k, p in model.named_parameters():
        # a parameter autograd never reaches (lin1 of the classifier, the
        # SAGE cells' unused root bias) has no grad; JAX's is zero
        g = np.zeros_like(ref[k]) if p.grad is None else p.grad.numpy()
        np.testing.assert_allclose(g, ref[k], rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("name", ["regressor0", "classifier1"])
def test_shipped_weights_loss_and_grads_match_jax(name):
    """The shipped checkpoints' trained weights, B=4, float32: the loss
    within rtol 1e-5 and each gradient tensor within 1e-4 of its own
    largest magnitude. (Elementwise, fp32 summation order puts up to
    1.7e-5 on a tensor of scale 0.45, classifier1's encoder pull l2.w,
    past 1e-6 + 1e-4 |g|; JAX's conv keeps its logits and messages in
    float32 even under x64, so a float64 comparison is not exact either.)"""
    params, hp, _ = jck.load(os.path.join(REPO, "artifacts", "40um", name))
    params = jax.tree_util.tree_map(jnp.asarray, params)
    jb, tb = batch_pair(4, seed=10)
    lval, grads = jax.jit(jax.value_and_grad(jtrainer.make_loss_fn(hp)))(
        params, jb)
    model = checkpoint.params_from_jax(params, port_hp(hp), device="cpu")
    out, _ = trainer.make_loss_fn(port_hp(hp))(model, tb, kernels=False)
    out.backward()
    np.testing.assert_allclose(float(out.detach()), float(lval), rtol=LOSS_RTOL)
    ref = flat_np(grads)
    for k, p in model.named_parameters():
        g = np.zeros_like(ref[k]) if p.grad is None else p.grad.numpy()
        scale = float(np.abs(ref[k]).max())
        np.testing.assert_allclose(g, ref[k], rtol=0,
                                   atol=GRAD_ATOL + GRAD_RTOL * scale, err_msg=k)


# ---------------------------------------------------------------------------
# Adam, the schedule and the transfer groups
# ---------------------------------------------------------------------------


def _optimizer_steps(hp, params, n_steps=3, steps_per_epoch=2):
    """n_steps of JAX's optimizer and the port's, both fed JAX's gradients
    at JAX's current params; after each step the params must agree.
    decay_step=1 and two steps an epoch put a decay after step 2."""
    jb, _ = batch_pair(2, seed=20)
    vg = jax.jit(jax.value_and_grad(jtrainer.make_loss_fn(hp)))
    tx = jtrainer.make_optimizer(hp, params, steps_per_epoch)
    opt_state = tx.init(params)
    model = checkpoint.params_from_jax(params, port_hp(hp), device="cpu")
    opt, sched = trainer.make_optimizer(port_hp(hp), model, steps_per_epoch)
    lrs = []
    for _ in range(n_steps):
        _, grads = vg(params, jb)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        g = flat_np(grads)
        for k, p in model.named_parameters():
            p.grad = torch.from_numpy(g[k].copy()) if p.requires_grad else None
        lrs.append([grp["lr"] for grp in opt.param_groups])
        opt.step()
        sched.step()
        want = flat_np(params)
        for k, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[k], rtol=0,
                                       atol=PARAM_ATOL, err_msg=k)
    return model, params, lrs


def test_adam_and_staircase_schedule_match_optax():
    hp = jhyper.regressor(0, layer_size=16, decay_step=1)
    params = jgn.init_regressor(jax.random.PRNGKey(8), hp)
    _, _, lrs = _optimizer_steps(hp, params)
    # the first step at lr (the schedule reads its count before the
    # increment), halved after two steps
    assert lrs == [[hp.lr], [hp.lr], [hp.lr / 2]]


def test_transfer_groups_match_optax_and_freeze_lin1():
    hp = jhyper.classifier_transfered(1, layer_size=16, decay_step=1,
                                      lr_1=0.5, lr_2=0.25, pos_weight=4.0)
    reg = jgn.init_regressor(jax.random.PRNGKey(1),
                             jhyper.regressor(0, layer_size=16))
    params = jgn.init_classifier(jax.random.PRNGKey(2), hp,
                                 regressor_params=reg)
    lin1 = flat_np(params["lin1"])
    model, jparams, lrs = _optimizer_steps(hp, params)
    lr = hp.lr
    assert lrs[0] == [lr * 0.5 * 0.25, lr * 0.25, lr]
    assert lrs[2] == [lr * 0.5 * 0.25 / 2, lr * 0.25 / 2, lr / 2]
    assert not model.lin1.w.requires_grad
    for k, v in lin1.items():
        np.testing.assert_array_equal(
            getattr(model.lin1, k).detach().numpy(), v)
        np.testing.assert_array_equal(np.asarray(jparams["lin1"][k]), v)


# ---------------------------------------------------------------------------
# data, checkpoints, the CLI
# ---------------------------------------------------------------------------


def test_shuffled_batches_match_jax():
    js = [jax_sample(s) for s in range(7)]
    ours = GraphDataset([to_port(s) for s in js])
    theirs = JGraphDataset(js)
    for seed in (35, 36):
        a = [b.grain_x.numpy() for b in ours.batches(3, shuffle=True, seed=seed)]
        b = [np.asarray(b.grain_x) for b in
             theirs.batches(3, shuffle=True, seed=seed)]
        assert len(a) == len(b) == 3
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("name", ["regressor0", "classifier1", "edge_len"])
def test_port_checkpoint_loads_in_jax_and_forwards_equal(tmp_path, name):
    """The port's save, read by JAX's checkpoint.load: the JAX forward on
    those params equals the port's; the port's own loader reads it back."""
    hp, _ = config(name)
    php = port_hp(hp)
    gen = torch.Generator().manual_seed(3)
    model = (grain_nn.init_regressor(php, gen) if hp.model_type == "regressor"
             else grain_nn.init_classifier(php, gen))
    path = str(tmp_path / "ckpt" / name)
    checkpoint.save(path, model, php, extra={"threshold": 0.7})
    jparams, jhp, extra = jck.load(path)
    assert dataclasses.asdict(jhp) == dataclasses.asdict(hp)
    assert extra == {"threshold": 0.7}
    jb, tb = batch_pair(2, seed=30)
    apply = (jgn.apply_regressor if hp.model_type == "regressor"
             else jgn.apply_classifier)
    ref = jax.vmap(lambda s: apply(jparams, jhp, s))(jb)
    with torch.no_grad():
        out = model(tb, kernels=True)
    for k in ref:
        r = np.asarray(ref[k])
        np.testing.assert_allclose(out[k].numpy().reshape(r.shape), r,
                                   rtol=0, atol=2e-5, err_msg=k)
    back, _, _ = checkpoint.load_model(path, device="cpu")
    for (k, a), (_, b) in zip(model.named_parameters(),
                              back.named_parameters()):
        assert torch.equal(a, b), k


def _write_dataset(path, n, ng=12):
    """n synthetic graphs in cli.extract --mode=train's pickle layout."""
    raw = []
    for s in range(n):
        f, e, w, m, t = synthetic.spatial_ring_arrays(ng, seed=s)
        raw.append({"feature_dicts": f, "target_dicts": t,
                    "edge_index_dicts": e, "edge_weight_dicts": w,
                    "mask": m, "physical_params": {"G": 1.0, "R": 1.0},
                    "span": 6})
    with open(path, "wb") as fh:
        pickle.dump(raw, fh)


def test_cli_train_on_the_cpu_writes_checkpoints_both_packages_load(tmp_path):
    from graingraphnn_torch.cli import train as cli

    data = str(tmp_path / "train.pkl")
    _write_dataset(data, 6)
    mdir = str(tmp_path / "model")
    cli.main(["--dataset", data, "--platform", "cpu", "--epochs", "1",
              "--model_dir", mdir, "--config",
              os.path.join(REPO, "artifacts/40um/regressor0.json")])
    cli.main(["--dataset", data, "--platform", "cpu", "--epochs", "1",
              "--model_dir", mdir, "--model_type", "classifier",
              "--model_id", "1"])
    for name, n in (("regressor0", 1_204_612), ("classifier1", 1_204_806)):
        jparams, jhp, extra = jck.load(os.path.join(mdir, name))
        assert jgn.count_params(jparams) == n
        model, hp, _ = checkpoint.load_model(os.path.join(mdir, name), "cpu")
        assert dataclasses.asdict(hp) == dataclasses.asdict(jhp)
    assert "threshold" in extra
    # the transfer classifier started from the trained regressor's stacks
    # and kept its lin1; regressor0.json's hp came through --config
    assert jhp.batch_size == 32 and jck.load(
        os.path.join(mdir, "regressor0"))[1].decay_step == 120
    if not torch.cuda.is_available():       # the default is the card
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cli.main(["--dataset", data, "--epochs", "1", "--model_dir", mdir])


# ---------------------------------------------------------------------------
# train_scanned, jitter, the kernels under autograd
# ---------------------------------------------------------------------------


def test_gr_jitter_replaces_thermal_columns_within_the_hull():
    rng = np.random.default_rng(0)
    jx = torch.from_numpy(rng.uniform(0, 1, (6, 40, 8)).astype(np.float32))
    hull = (0.5, 10.0, 0.2, 2.0)
    gen = torch.Generator().manual_seed(1)
    all_ = trainer.jitter_gr(jx, gen, 1.0, hull)
    none = trainer.jitter_gr(jx, gen, 0.0, hull)
    assert torch.equal(none, jx)
    other = [c for c in range(8) if c not in (3, 4)]
    assert torch.equal(all_[..., other], jx[..., other])
    g = 10.0 * (1.0 - all_[..., 3])
    r = 2.0 * all_[..., 4]
    # one draw per sample, inside the hull
    assert bool((g.amax(1) - g.amin(1) < 1e-5).all())
    assert bool((r.amax(1) - r.amin(1) < 1e-6).all())
    assert bool(((g > 0.5 - 1e-5) & (g < 10.0 + 1e-5)).all())
    assert bool(((r >= 0.2) & (r <= 2.0)).all())
    half = trainer.jitter_gr(jx, torch.Generator().manual_seed(2), 0.5, hull)
    # a coin per sample: both columns kept or both replaced
    assert bool(((half[..., 3] == jx[..., 3]).all(1)
                 == (half[..., 4] == jx[..., 4]).all(1)).all())


def test_train_scanned_follows_the_numpy_permutation():
    """run_epoch takes its batches in default_rng(seed).permutation order,
    dropping the partial one, and train_scanned trains with jitter."""
    samples = [to_port(jax_sample(s)) for s in range(5)]
    data = state.stack(samples)
    seen = []
    perm = np.random.default_rng(35).permutation(5)
    trainer.run_epoch(lambda b: seen.append(b.grain_x) or torch.zeros(()),
                      data, perm, 2)
    assert len(seen) == 2
    for i, x in enumerate(seen):
        want = torch.cat([samples[j].grain_x for j in perm[2 * i:2 * i + 2]])
        assert torch.equal(x, want)
    hp = hyper.regressor(0, layer_size=8, batch_size=2)
    model = grain_nn.init_regressor(hp, torch.Generator().manual_seed(0))
    _, hist = trainer.train_scanned(hp, model, GraphDataset(samples[:4]),
                                    GraphDataset(samples[4:]), epochs=2,
                                    gr_jitter=True, log=lambda s: None)
    assert len(hist["train_loss"]) == 2 and np.isfinite(hist["train_loss"]).all()
    assert len(hist["valid_loss"]) == 1


def test_train_trains_and_matches_jax_epoch_zero():
    """trainer.train: the epoch-0 losses equal JAX's on the same params and
    batches; training lowers the loss; a transfer classifier gets its
    threshold."""
    hp = jhyper.regressor(0, layer_size=8)
    params = jgn.init_regressor(jax.random.PRNGKey(0), hp)
    js = [jax_sample(s) for s in range(6)]
    quiet = dict(epochs=2, log=lambda s: None)
    _, jh = jtrainer.train(hp, params, JGraphDataset(js[:4]),
                           JGraphDataset(js[4:]), **quiet)
    model = checkpoint.params_from_jax(params, port_hp(hp), device="cpu")
    _, th = trainer.train(port_hp(hp), model,
                          GraphDataset([to_port(s) for s in js[:4]]),
                          GraphDataset([to_port(s) for s in js[4:]]), **quiet)
    np.testing.assert_allclose(th["train_loss"][:2], jh["train_loss"][:2],
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(th["valid_loss"][0], jh["valid_loss"][0],
                               rtol=LOSS_RTOL)
    assert th["train_loss"][-1] < th["train_loss"][0]


def test_kernel_wrappers_raise_under_autograd():
    """The edge stage kernels have no backward: with grad mode on and a
    weight or input that requires grad, every wrapper raises before it
    looks at the device."""
    conv = grain_nn.build(hyper.regressor(0, layer_size=8)).encoder[0].conv["push"]
    xs, xd = torch.rand(5, 19), torch.rand(4, 16)
    nbr = torch.zeros(4, 3, dtype=torch.int32)
    f = torch.ones(4, 3)
    kw = dict(num_gates=4, out_channels=8)
    with pytest.raises(RuntimeError, match="no backward"):
        edge_stage.apply_period_conv_cuda(conv, xs, xd, nbr, f, f, **kw)
    with pytest.raises(RuntimeError, match="no backward"):
        edge_stage.node_proj_cuda(conv, xs, xd)
    proj = tuple(t.detach() for t in
                 period_conv.node_projections_plain(conv, xs, xd))
    with pytest.raises(RuntimeError, match="no backward"):
        edge_stage.edge_attn_cuda(conv, xs, xd, nbr, f, f, proj, **kw)
    conv.requires_grad_(False)
    with pytest.raises(RuntimeError, match="no backward"):
        edge_stage.apply_period_conv_cuda(conv, xs.requires_grad_(), xd, nbr,
                                          f, f, **kw)
    with torch.no_grad(), pytest.raises(ValueError, match="on cpu"):
        edge_stage.apply_period_conv_cuda(conv, xs, xd, nbr, f, f, **kw)
