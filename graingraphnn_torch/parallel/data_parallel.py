"""Data-parallel training over the ranks of a mesh axis.

Every rank draws the same global batch; `shard_batch` gives it its
contiguous block of B / dp samples (the JAX package shards the leading
axis the same way). `make_dp_train_step` packs that block, takes
trainer.make_loss_fn's mean over it, and averages the gradients over the
ranks as one flattened bucket through Mesh.all_reduce, so that one path
serves NCCL (device buffers) and the host-staged gloo of ranks that share
one card. torch's DistributedDataParallel is not used: its reducer does
not stage through the host.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..graph import state
from ..graph.state import GraphSample
from ..models.hyper import HyperParams
from ..train.trainer import make_loss_fn
from .mesh import Mesh
from .partition import reduce_grads, shard_samples


def shard_batch(batch: GraphSample, mesh: Mesh,
                axis: Optional[str] = None) -> GraphSample:
    """This rank's contiguous block of the stacked global batch [B, ...]
    along `axis` (B a multiple of its size), on mesh.device."""
    return shard_samples(batch, mesh.index(axis),
                         mesh.size(axis)).to(mesh.device)


def make_dp_train_step(hp: HyperParams, model, opt, sched, mesh: Mesh,
                       axis: Optional[str] = None):
    """step(batch) -> the global batch's mean loss: forward and backward
    of this rank's packed block (the torch formulation), the gradients
    averaged over the axis, one optimizer and one schedule step. Every
    rank holds the same parameters before and after."""
    batch_loss = make_loss_fn(hp)
    n = mesh.size(axis)

    def step(batch: GraphSample) -> torch.Tensor:
        packed = state.pack(shard_batch(batch, mesh, axis))
        opt.zero_grad(set_to_none=True)
        lval, _ = batch_loss(model, packed, kernels=False)
        lval.backward()
        reduce_grads(model, mesh, axis, 1.0 / n)
        opt.step()
        sched.step()
        return mesh.all_reduce(lval.detach(), axis=axis) / n

    return step
