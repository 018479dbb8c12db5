"""Graph partitioning by node rows: one graph split over the ranks of a
mesh axis, each rank computing the gates of its own block of destination
rows.

A rank holds a contiguous block of the node rows, of their ELL rows and of
the jj edge rows (`shard_rows`); the ELL and jj indices stay global, so
before each conv the source tables are all-gathered over the axis
(`src_gather`), and the jj heads read the all-gathered joint table
(`node_gather`). Correct for any split because the indices are global.

- `make_partitioned_forward`: the models' forward on a rank's block, its
  outputs all-gathered; under inference on the hand kernels, which on a
  card see the gathered source tables (Ns = N) and the block's
  destinations (Nd = N / D).
- `make_partitioned_train_step`: each rank differentiates its partial
  loss, the torch formulation of the conv (the kernels have no backward);
  the loss value and the gradients are then each summed once over the
  axis. The all-gather's backward is a reduce-scatter, so the cotangents
  of a rank's rows reach it from every rank. A reduction inside the
  differentiated function would replicate cotangents and the sum of the
  gradients after it would count them D times (Adam, invariant to a
  constant scale, would hide that), hence the partial loss.
- `make_hybrid_train_step`: a 2-D mesh, the batch split over `dp` and
  each sample's rows over `gp`; grads summed over gp, averaged over dp.

As in the JAX package, the partial regressor loss has no edge-length
term, and the classifier's denominator is the valid count summed over
the axis, without gradient.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..graph.state import GraphSample
from ..models.hyper import HyperParams
from .mesh import Mesh

# fields split by node row (grain or joint tables and their ELL rows) and
# by jj edge row; the row counts n_* are replicated
_GRAIN_ROWS = ("grain_x", "grain_mask", "pull_nbr", "pull_len", "pull_mask",
               "y_grain", "y_grain_event")
_JOINT_ROWS = ("joint_x", "joint_mask", "push_nbr", "push_len", "push_mask",
               "connect_nbr", "connect_len", "connect_mask", "y_joint")
_JJ_ROWS = ("jj_src", "jj_dst", "jj_len", "jj_mask", "y_edge_event",
            "y_edge", "y_edge_mask")


def shard_rows(sample: GraphSample, rank: int, D: int) -> GraphSample:
    """Rank `rank`'s block of a single sample's rows out of D contiguous
    blocks: grain rows, joint rows (with their ELL rows) and jj rows; the
    row counts replicated, indices kept global. Every capacity must be a
    multiple of D."""
    out = {}
    for f in dataclasses.fields(GraphSample):
        v = getattr(sample, f.name)
        if v is None or f.name not in _GRAIN_ROWS + _JOINT_ROWS + _JJ_ROWS:
            out[f.name] = v
            continue
        n = v.shape[0]
        if n % D:
            raise ValueError(f"{f.name}: {n} rows do not split over {D} "
                             "ranks (capacities must be multiples of D)")
        b = n // D
        out[f.name] = v[rank * b: (rank + 1) * b]
    return GraphSample(**out)


def pad_rows(sample: GraphSample, multiple: int) -> GraphSample:
    """sample with its grain, joint and jj rows padded with zeros (masked
    rows, masked slots) up to multiples of `multiple`, so that shard_rows
    can split it."""
    out = {}
    for f in dataclasses.fields(GraphSample):
        v = getattr(sample, f.name)
        if v is not None and f.name in _GRAIN_ROWS + _JOINT_ROWS + _JJ_ROWS:
            extra = -v.shape[0] % multiple
            if extra:
                v = torch.cat([v, v.new_zeros((extra,) + tuple(v.shape[1:]))])
        out[f.name] = v
    return GraphSample(**out)


def gathers(mesh: Mesh, axis: Optional[str] = None):
    """(src_gather, node_gather): the node tables all-gathered over the
    axis, blocks concatenated in axis order (JAX's tiled all_gather);
    differentiable."""
    def gather(x):
        return mesh.all_gather(x, axis).reshape((-1,) + tuple(x.shape[1:]))

    return (lambda xg, xj: (gather(xg), gather(xj))), gather


def make_partitioned_forward(model, mesh: Mesh, axis: Optional[str] = None):
    """f(sample) -> the model's outputs over the whole sample on every
    rank. Each rank runs its block of `sample` (shard_rows) on
    mesh.device under inference mode, on the hand kernels (a card's
    node_proj and edge_attn see Ns = N gathered source rows and Nd = N/D
    destination rows), and all-gathers the outputs."""
    src_gather, node_gather = gathers(mesh, axis)

    def f(sample: GraphSample) -> Dict[str, torch.Tensor]:
        local = shard_rows(sample, mesh.index(axis),
                           mesh.size(axis)).to(mesh.device)
        with torch.inference_mode():
            y = model(local, kernels=True, src_gather=src_gather,
                      node_gather=node_gather)
            return {k: mesh.all_gather(v, axis).reshape(
                (-1,) + tuple(v.shape[1:])) for k, v in y.items()}

    return f


def partial_loss(hp: HyperParams, model, local: GraphSample, mesh: Mesh,
                 axis: Optional[str], src_gather, node_gather):
    """This rank's additive term of one sample's loss, on the torch
    formulation of the conv. No collective on the loss inside: the
    regressor's masked squared errors over its rows divided by the
    replicated row counts (no edge-length term, as in the JAX package),
    the classifier's BCE over its valid jj rows divided by the valid count
    summed over the axis (no gradient)."""
    pred = model(local, kernels=False, src_gather=src_gather,
                 node_gather=node_gather)
    if hp.model_type == "regressor":
        jm = local.joint_mask[:, None]
        gm = local.grain_mask[:, None]
        j_sq = torch.sum(jm * (local.y_joint - pred["joint"]) ** 2)
        g_sq = torch.sum(gm * (local.y_grain - pred["grain"]) ** 2)
        return 100.0 * (j_sq / (local.n_joint_rows * 2.0)
                        + g_sq / (local.n_grain_rows * 2.0))
    z = pred["edge_event"]
    y = local.y_edge_event
    valid = (y > -1.0).to(z.dtype) * local.jj_mask
    y01 = torch.clamp(y, 0.0, 1.0)
    per_edge = (hp.pos_weight * y01 * F.softplus(-z)
                + (1.0 - y01) * F.softplus(z))
    den = torch.clamp_min(mesh.all_reduce(torch.sum(valid), axis=axis), 1.0)
    return torch.sum(per_edge * valid) / den


def reduce_grads(model, mesh: Mesh, axis: Optional[str] = None,
                 scale: float = 1.0):
    """Sum every parameter gradient over the axis, as one flattened bucket
    through mesh.all_reduce, times `scale`. A parameter without a gradient
    (frozen, or outside the loss) has none on every rank and is left so."""
    params = [p for p in model.parameters() if p.grad is not None]
    if not params:
        return
    flat = mesh.all_reduce(torch.cat([p.grad.reshape(-1) for p in params]),
                           axis=axis)
    if scale != 1.0:
        flat = flat * scale
    pos = 0
    for p in params:
        n = p.numel()
        p.grad.copy_(flat[pos: pos + n].view_as(p))
        pos += n


def make_partitioned_train_step(hp: HyperParams, model, opt, sched,
                                mesh: Mesh, axis: Optional[str] = None):
    """step(sample) -> the loss of one graph, its rows split over the
    axis: each rank differentiates its partial loss on its block, then the
    loss and the gradients are summed once over the axis, and the
    optimizer and the schedule step. Every rank holds the same
    parameters before and after."""
    src_gather, node_gather = gathers(mesh, axis)

    def step(sample: GraphSample) -> torch.Tensor:
        local = shard_rows(sample, mesh.index(axis),
                           mesh.size(axis)).to(mesh.device)
        opt.zero_grad(set_to_none=True)
        lval = partial_loss(hp, model, local, mesh, axis, src_gather,
                            node_gather)
        lval.backward()
        reduce_grads(model, mesh, axis)
        opt.step()
        sched.step()
        return mesh.all_reduce(lval.detach(), axis=axis)

    return step


def make_hybrid_train_step(hp: HyperParams, model, opt, sched, mesh: Mesh,
                           dp_axis: str = "dp", gp_axis: str = "gp"):
    """step(batch) -> the batch's mean loss on a 2-D mesh: the stacked
    batch [B, ...] split into contiguous blocks of B / dp samples over
    `dp_axis`, each sample's rows over `gp_axis`. A rank's loss is the
    mean of its samples' partial losses (a loop over them); the
    gradients are summed over gp and averaged over dp, the loss too."""
    src_gather, node_gather = gathers(mesh, gp_axis)
    dp, gp = mesh.size(dp_axis), mesh.size(gp_axis)

    def step(batch: GraphSample) -> torch.Tensor:
        mine = shard_samples(batch, mesh.index(dp_axis), dp)
        B = mine.grain_x.shape[0]
        opt.zero_grad(set_to_none=True)
        lval = 0.0
        for b in range(B):
            local = shard_rows(mine.map(lambda t: t[b]),
                               mesh.index(gp_axis), gp).to(mesh.device)
            lval = lval + partial_loss(hp, model, local, mesh, gp_axis,
                                       src_gather, node_gather)
        lval = lval / B
        lval.backward()
        # the sum over the whole mesh is the sum over gp of the sums over
        # dp: divided by dp, the gp sum of the dp mean
        reduce_grads(model, mesh, None, 1.0 / dp)
        opt.step()
        sched.step()
        return mesh.all_reduce(lval.detach()) / dp

    return step


def shard_samples(batch: GraphSample, index: int, n: int) -> GraphSample:
    """The index-th of n contiguous blocks of a stacked batch [B, ...]
    (B a multiple of n)."""
    B = batch.grain_x.shape[0]
    if B % n:
        raise ValueError(f"a batch of {B} does not split over {n} ranks")
    b = B // n
    return batch.map(lambda t: t[index * b: (index + 1) * b])
