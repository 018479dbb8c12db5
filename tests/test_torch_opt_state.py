"""Optimizer state in the port's checkpoints: save(opt_state=) writes the
torch Adam's and StepLR's state as numpy beside the weights, load
returns it, and a run resumed from it continues as the uninterrupted run
does; opt_state_from_jax carries the JAX package's optax Adam state
(trainer.make_optimizer's, the transfer classifier's multi_transform
too) into the torch Adam, so that one step from it equals JAX's next
step."""

import copy
import pickle

import jax
import numpy as np
import optax
import pytest
import torch

from graingraphnn_torch.graph import state as tstate
from graingraphnn_torch.models import hyper as thyper
from graingraphnn_torch.train import checkpoint
from graingraphnn_torch.train import trainer as ttrainer
from graingraphnn_tpu.graph import state as jstate
from graingraphnn_tpu.models import grain_nn, hyper
from graingraphnn_tpu.train import trainer as jtrainer
from tests.test_torch_dist_train import graph


def batches(n=2, B=2):
    """n batches of B samples: (JAX stacked, port packed)."""
    out = []
    for k in range(n):
        arrays = [graph(k * B + i) for i in range(B)]
        out.append((jstate.stack([jstate.build_sample(*a) for a in arrays]),
                    tstate.pack(tstate.stack([
                        tstate.build_sample(*a, device="cpu")
                        for a in arrays]))))
    return out


def configs(make):
    if make == "regressor":
        return (hyper.regressor(0, layer_size=8, batch_size=2, decay_step=1),
                thyper.regressor(0, layer_size=8, batch_size=2, decay_step=1),
                grain_nn.init_regressor)
    return (hyper.classifier_transfered(1, layer_size=8, batch_size=2),
            thyper.classifier_transfered(1, layer_size=8, batch_size=2),
            grain_nn.init_classifier)


def _name(path):
    return ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


@pytest.mark.parametrize("make", ["regressor", "classifier_transfered"])
def test_one_step_from_carried_jax_state_equals_jax(make):
    """JAX takes a train step (the schedule then halves the rate:
    decay_step 1 at one step an epoch); its weights and optimizer state
    are carried into the port (mu, nu and count exactly); then both apply
    one optimizer step to the same gradients (numpy-seeded): the updates
    agree, the transfer classifier's frozen lin1 stays put. The next train
    step's loss from the carried weights is JAX's."""
    hp, thp, init = configs(make)
    (jb1, _), (jb2, tb2) = batches()
    params = init(jax.random.PRNGKey(0), hp)
    tx = jtrainer.make_optimizer(hp, params, 1)
    p1, o1, _ = jtrainer.make_train_step(hp, tx)(params, tx.init(params),
                                                 jb1)
    _, _, l2 = jtrainer.make_train_step(hp, tx)(p1, o1, jb2)

    model = checkpoint.params_from_jax(p1, thp, "cpu")
    opt, sched = ttrainer.make_optimizer(thp, model, 1)
    checkpoint.opt_state_from_jax(o1, model, opt, sched)
    assert sched.last_epoch == 1
    adams, _ = checkpoint._adam_states(o1)
    mu = {k: v for a in adams for k, v in checkpoint._flatten(a.mu).items()}
    for n, p in model.named_parameters():
        if p.requires_grad:
            st = opt.state[p]
            np.testing.assert_array_equal(st["exp_avg"].numpy(),
                                          np.asarray(mu[n]), err_msg=n)
            assert float(st["step"]) == 1.0
    with torch.no_grad():
        lval, _ = ttrainer.make_loss_fn(thp)(model, tb2, kernels=False)
    np.testing.assert_allclose(float(lval), float(l2), rtol=1e-5)

    rng = np.random.default_rng(5)
    grads = jax.tree_util.tree_map_with_path(
        lambda path, v: rng.normal(size=np.shape(v)).astype(np.float32)
        * 1e-2, p1)
    g_flat = {_name(path): g for path, g in
              jax.tree_util.tree_flatten_with_path(grads)[0]}
    updates, _ = tx.update(grads, o1, p1)
    p2 = checkpoint._flatten(optax.apply_updates(p1, updates))
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    for n, p in model.named_parameters():
        if p.requires_grad:
            p.grad = torch.from_numpy(g_flat[n])
    opt.step()
    for n, p in model.named_parameters():
        got = (p.detach() - before[n]).numpy()
        want = np.asarray(p2[n]) - before[n].numpy()
        # atol: two float32 spacings of weights below 1, which both
        # updates are read through
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1.2e-7,
                                   err_msg=n)
        if not p.requires_grad:
            assert not want.any() and not got.any(), n


def test_opt_state_from_jax_refuses_a_tree_without_adam():
    model = checkpoint.params_from_jax(
        grain_nn.init_regressor(jax.random.PRNGKey(0),
                                hyper.regressor(0, layer_size=8)),
        thyper.regressor(0, layer_size=8), "cpu")
    opt, _ = ttrainer.make_optimizer(thyper.regressor(0, layer_size=8),
                                     model, 1)
    with pytest.raises(ValueError, match="no Adam state"):
        checkpoint.opt_state_from_jax(({"count": 1},), model, opt)


def test_checkpoint_resume_continues_the_run(tmp_path):
    """Two steps straight, against one step, save(opt_state=), load into a
    fresh model and optimizer, one step: the same weights and the same
    optimizer state, bit for bit. The pickle holds numpy and builtins only
    (JAX's checkpoint.load reads the file)."""
    hp, thp, init = configs("regressor")
    (_, tb1), (_, tb2) = batches()
    start = checkpoint.params_from_jax(init(jax.random.PRNGKey(0), hp), thp,
                                       "cpu")

    def fresh(model):
        opt, sched = ttrainer.make_optimizer(thp, model, 1)
        return opt, sched, ttrainer.make_train_step(thp, model, opt, sched)

    straight = copy.deepcopy(start)
    _, _, step = fresh(straight)
    step(tb1)
    l_straight = float(step(tb2))

    first = copy.deepcopy(start)
    opt, sched, step = fresh(first)
    step(tb1)
    path = str(tmp_path / "ck")
    checkpoint.save(path, first, thp, opt_state=checkpoint.opt_state_of(
        opt, sched, epoch=1))
    tree, hp2, _extra, saved = checkpoint.load(path, opt_state=True)
    assert saved["epoch"] == 1 and hp2 == thp
    assert len(checkpoint.load(path)) == 3
    model = checkpoint.params_from_jax(tree, hp2, "cpu")
    opt2, sched2, step2 = fresh(model)
    checkpoint.restore_opt_state(opt2, sched2, saved)
    assert sched2.last_epoch == sched.last_epoch
    assert float(step2(tb2)) == l_straight
    for (n, a), (_, b) in zip(straight.named_parameters(),
                              model.named_parameters()):
        assert torch.equal(a, b), n
    from graingraphnn_tpu.train import checkpoint as jck

    jtree, _jhp, _ = jck.load(path)
    assert set(checkpoint._flatten(jtree)) == set(
        dict(model.named_parameters()))
    with open(path + ".ckpt", "rb") as f:
        payload = pickle.load(f)
    assert isinstance(payload["opt_state"]["optimizer"]["state"][0]
                      ["exp_avg"], np.ndarray)
