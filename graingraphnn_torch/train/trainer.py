"""Training loops on torch.optim.

Optimizer: Adam (optax's defaults: betas 0.9/0.999, eps 1e-8) with a
staircase decay, the learning rate halved every `decay_step` epochs of
optimizer steps; the first step runs at `lr`, as optax's schedule reads its
count before the increment. A transfer classifier has three parameter
groups: encoder lr*lr_1*lr_2, decoder lr*lr_2, lin2 lr; lin1 is frozen at
its initialisation (out of every group, requires_grad off), where the JAX
package zeroes its updates. `hp.weight_decay` is not applied, as in the JAX
package.

A batch is B equally padded samples packed into one disjoint graph
(graph.state.pack), which the models run as one sample; the loss is the
mean of the per-sample losses. The train step's forward and backward take
the torch formulation of the conv under autograd (kernels=False: the hand
kernels have no backward); evaluation forwards run under torch.no_grad()
on the hand kernels (kernels=True), which on the card launch node_proj and
edge_attn.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..data.dataset import GraphDataset
from ..graph import state
from ..graph.state import GraphSample
from ..models import grain_nn
from ..models.hyper import HyperParams
from . import loss as loss_mod
from .metrics import FeatureMetric


def make_optimizer(hp: HyperParams, model: torch.nn.Module,
                   steps_per_epoch: int):
    """(Adam, StepLR): call the scheduler's step() after each optimizer
    step."""
    if hp.transfer and hp.model_type == "classifier":
        model.lin1.requires_grad_(False)
        groups = [
            {"params": list(model.encoder.parameters()),
             "lr": hp.lr * hp.lr_1 * hp.lr_2},
            {"params": list(model.decoder.parameters()), "lr": hp.lr * hp.lr_2},
            {"params": list(model.lin2.parameters()), "lr": hp.lr},
        ]
    else:
        groups = [{"params": list(model.parameters()), "lr": hp.lr}]
    opt = torch.optim.Adam(groups, lr=hp.lr, betas=(0.9, 0.999), eps=1e-8)
    sched = torch.optim.lr_scheduler.StepLR(
        opt, step_size=max(1, hp.decay_step * steps_per_epoch), gamma=0.5)
    return opt, sched


def make_loss_fn(hp: HyperParams) -> Callable:
    """batch_loss(model, packed, *, kernels) -> the mean per-sample loss and
    the predictions."""
    if hp.model_type == "regressor":
        def per_sample(pred, s):
            return loss_mod.regressor_loss(pred, s, edge_len=hp.edge_len)
    else:
        def per_sample(pred, s):
            return loss_mod.classifier_loss(pred, s, pos_weight=hp.pos_weight)
    mean = loss_mod.batched(per_sample)

    def batch_loss(model, packed: GraphSample, *, kernels: bool):
        pred = model(packed, kernels=kernels)
        return mean(pred, packed), pred

    return batch_loss


def make_train_step(hp: HyperParams, model, opt, sched):
    """step(packed) -> the batch's loss (a device scalar): forward and
    backward on the torch formulation, one Adam step, one schedule step."""
    batch_loss = make_loss_fn(hp)

    def step(packed: GraphSample) -> torch.Tensor:
        opt.zero_grad(set_to_none=True)
        lval, _ = batch_loss(model, packed, kernels=False)
        lval.backward()
        opt.step()
        sched.step()
        return lval.detach()

    return step


def make_eval_fn(hp: HyperParams, model):
    """evaluate(packed) -> (loss, pred) without autograd, on the hand
    kernels."""
    batch_loss = make_loss_fn(hp)

    @torch.no_grad()
    def evaluate(packed: GraphSample):
        return batch_loss(model, packed, kernels=True)

    return evaluate


def _sample_np(batch: GraphSample) -> Dict[str, np.ndarray]:
    return {k: getattr(batch, k).cpu().numpy() for k in (
        "grain_mask", "joint_mask", "y_grain", "y_joint", "y_grain_event",
        "y_edge_event")}


def _pred_np(pred):
    return {k: v.cpu().numpy() for k, v in pred.items()}


def _evaluate(eval_fn, ds: GraphDataset, batch_size: int, metric,
              first_epoch: bool) -> float:
    tot, count = 0.0, 0
    for batch in ds.batches(batch_size):
        packed = state.pack(batch)
        lval, pred = eval_fn(packed)
        tot += float(lval)
        count += 1
        metric.record(None, _pred_np(pred), _sample_np(packed), first_epoch)
    return tot / max(count, 1)


def train(
    hp: HyperParams,
    model,
    train_ds: GraphDataset,
    valid_ds: GraphDataset,
    *,
    epochs: Optional[int] = None,
    log: Callable[[str], None] = print,
    eval_batch_size: int = 64,
    seed: int = 35,
):
    """The training loop: an epoch-0 evaluation, then per epoch the shuffled
    batches (seed + epoch) and a validation pass. Trains `model` in place on
    the device its samples lie on; returns (model, history)."""
    epochs = epochs if epochs is not None else hp.epoch
    steps_per_epoch = max(1, len(train_ds) // hp.batch_size)
    opt, sched = make_optimizer(hp, model, steps_per_epoch)
    step_fn = make_train_step(hp, model, opt, sched)
    eval_fn = make_eval_fn(hp, model)
    metric = FeatureMetric(hp.model_type)
    history = {"train_loss": [], "valid_loss": [], "metrics": []}

    t0 = time.time()
    tot, count = 0.0, 0
    for batch in train_ds.batches(hp.batch_size):
        tot += float(eval_fn(state.pack(batch))[0])
        count += 1
    train_l = tot / max(count, 1)
    valid_l = _evaluate(eval_fn, valid_ds, eval_batch_size, metric, True)
    log(f"Epoch:0, Train loss:{train_l:.6f}, valid loss:{valid_l:.6f}")
    history["train_loss"].append(train_l)
    history["valid_loss"].append(valid_l)
    history["metrics"].append(metric.epoch_summary())
    log(f"total number of trained parameters {grain_nn.count_params(model)}")

    for epoch in range(1, epochs + 1):
        tot, count = 0.0, 0
        for batch in train_ds.batches(hp.batch_size, shuffle=True,
                                      seed=seed + epoch):
            tot += float(step_fn(state.pack(batch)))
            count += 1
        train_l = tot / max(count, 1)
        valid_l = _evaluate(eval_fn, valid_ds, eval_batch_size, metric, False)
        history["train_loss"].append(train_l)
        history["valid_loss"].append(valid_l)
        history["metrics"].append(metric.epoch_summary())
        log(f"Epoch:{epoch}, Train loss:{train_l:.6f}, valid loss:{valid_l:.6f}")

    history["time"] = time.time() - t0
    if hp.model_type == "classifier":
        thr, p, r = metric.optimal_threshold()
        history["threshold"] = thr
        log(f"the optimal threshold for classification is: {thr} "
            f"with precision/recall {p:.3f}/{r:.3f}")
    return model, history


def jitter_gr(joint_x: torch.Tensor, generator: torch.Generator, p: float,
              hull: tuple) -> torch.Tensor:
    """joint_x [B, NJ, F] with each sample's thermal columns (G at 3, R at
    4) replaced, with probability p, by one uniform draw over the hull
    (G_lo, G_hi, R_lo, R_hi), featurised as 1 - G/10 and R/2; a kept sample
    keeps its own per-joint columns."""
    B = joint_x.shape[0]
    u = torch.rand((3, B, 1), generator=generator, device=joint_x.device)
    g = hull[0] + (hull[1] - hull[0]) * u[0]
    r = hull[2] + (hull[3] - hull[2]) * u[1]
    keep = u[2] >= p
    jx = joint_x.clone()
    jx[:, :, 3] = torch.where(keep, joint_x[:, :, 3], 1.0 - g / 10.0)
    jx[:, :, 4] = torch.where(keep, joint_x[:, :, 4], r / 2.0)
    return jx


def run_epoch(step_fn, data: GraphSample, perm: np.ndarray, batch_size: int,
              generator: Optional[torch.Generator] = None,
              gr_jitter_p: float = 1.0, gr_hull: tuple = ()) -> float:
    """One epoch over the stacked dataset `data` on its device: the batches
    of `perm` (the last partial one dropped) gathered on the device, the
    loss summed there, one host sync at the end. With a generator, each
    batch's G,R columns are jittered (jitter_gr). Returns the mean loss."""
    dev = data.grain_x.device
    steps = len(perm) // batch_size
    idx = torch.from_numpy(perm[: steps * batch_size].astype(np.int64))
    if dev.type == "cuda":
        idx = idx.pin_memory()
    idx = idx.to(dev, non_blocking=True).reshape(steps, batch_size)
    total = torch.zeros((), device=dev)
    for s in range(steps):
        batch = data.map(lambda t: t.index_select(0, idx[s]))
        if generator is not None:
            batch.joint_x = jitter_gr(batch.joint_x, generator, gr_jitter_p,
                                      gr_hull)
        total = total + step_fn(state.pack(batch))
    return float(total / steps)


def train_scanned(
    hp: HyperParams,
    model,
    train_ds: GraphDataset,
    valid_ds: GraphDataset,
    *,
    epochs: Optional[int] = None,
    log: Callable[[str], None] = print,
    eval_every: int = 10,
    eval_batch_size: int = 64,
    seed: int = 35,
    gr_jitter: bool = False,
    gr_jitter_p: float = 1.0,
    gr_hull: tuple = (0.5, 10.0, 0.2, 2.0),
):
    """Device-resident training: the whole dataset is stacked once on the
    samples' device, and each epoch (run_epoch) draws one numpy permutation
    (default_rng(seed)), gathers its batches there and syncs with the host
    once. Validation every `eval_every` epochs and after the last.

    gr_jitter=True resamples each sample's thermal features per step over
    the G,R hull (G in [0.5, 10], R in [0.2, 2] by default), keeping the
    true ones with probability 1 - gr_jitter_p, from a device generator
    seeded seed*1000 + epoch: with a single-seed corpus the true
    (G, R)-response cannot be learnt, and jitter teaches the invariance
    instead of extrapolating a spurious response out of the hull."""
    epochs = epochs if epochs is not None else hp.epoch
    B = hp.batch_size
    data = state.stack(train_ds.samples)
    N = len(train_ds)
    opt, sched = make_optimizer(hp, model, N // B)
    step_fn = make_train_step(hp, model, opt, sched)
    eval_fn = make_eval_fn(hp, model)
    metric = FeatureMetric(hp.model_type)
    history = {"train_loss": [], "valid_loss": [], "metrics": []}
    rng = np.random.default_rng(seed)
    dev = data.grain_x.device
    t0 = time.time()
    for epoch in range(1, epochs + 1):
        gen = None
        if gr_jitter:
            gen = torch.Generator(device=dev).manual_seed(seed * 1000 + epoch)
        train_l = run_epoch(step_fn, data, rng.permutation(N), B, gen,
                            gr_jitter_p, gr_hull)
        history["train_loss"].append(train_l)
        if epoch % eval_every == 0 or epoch == epochs:
            # the first evaluation records the reference magnitudes
            valid_l = _evaluate(eval_fn, valid_ds, eval_batch_size, metric,
                                not history["valid_loss"])
            history["valid_loss"].append(valid_l)
            history["metrics"].append(metric.epoch_summary(verbose=False))
            log(f"Epoch:{epoch}, Train loss:{train_l:.6f}, "
                f"valid loss:{valid_l:.6f}, "
                f"AUC:{history['metrics'][-1]['PR_AUC']:.4f}")
    history["time"] = time.time() - t0
    if hp.model_type == "classifier" and history["metrics"]:
        thr, p_, r_ = metric.optimal_threshold()
        history["threshold"] = thr
        log(f"optimal threshold {thr} (P {p_:.3f} / R {r_:.3f})")
    return model, history
