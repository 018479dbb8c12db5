"""Training losses, exact under padding and packing.

Each loss takes a sample packed from B equally padded samples
(graph.state.pack; B = 1 for a single sample) and returns the [B] per-sample
losses: sums run over each sample's own rows and are divided by its stored
unpadded row counts, so a value does not depend on the padding capacity or
on the other samples of the batch. `batched` averages them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..graph.state import GraphSample, num_samples


def _per_sample(x: torch.Tensor, B: int) -> torch.Tensor:
    """Sum of x over everything but the packed sample axis: [B]."""
    return x.reshape(B, -1).sum(dim=1)


def regressor_loss(pred: dict, sample: GraphSample, edge_len: bool = False):
    """100 * (sum_j mask*(y-p)^2 / (2 n_joint) + sum_g mask*(y-p)^2 /
    (2 n_grain)) per sample, plus the masked edge-length error over the
    live jj edges with edge_len."""
    B = num_samples(sample)
    jm = sample.joint_mask[:, None]
    gm = sample.grain_mask[:, None]
    j_sq = _per_sample(jm * (sample.y_joint - pred["joint"]) ** 2, B)
    g_sq = _per_sample(gm * (sample.y_grain - pred["grain"]) ** 2, B)
    loss = (j_sq / (sample.n_joint_rows.reshape(B) * 2.0)
            + g_sq / (sample.n_grain_rows.reshape(B) * 2.0))
    if edge_len and "edge" in pred:
        e_sq = _per_sample(sample.y_edge_mask * (sample.y_edge - pred["edge"]) ** 2, B)
        loss = loss + e_sq / torch.clamp_min(sample.n_jj_rows.reshape(B), 1.0)
    return 100.0 * loss


def classifier_loss(pred: dict, sample: GraphSample, pos_weight: float = 1.0):
    """BCE with logits and a positive-class weight, over each sample's valid
    (label > -1) live jj edges, in the log-sigmoid form
    -[w*y*log s(z) + (1-y)*log(1-s(z))]."""
    B = num_samples(sample)
    z = pred["edge_event"]
    y = sample.y_edge_event
    valid = (y > -1.0).to(z.dtype) * sample.jj_mask
    y01 = torch.clamp(y, 0.0, 1.0)
    per_edge = pos_weight * y01 * F.softplus(-z) + (1.0 - y01) * F.softplus(z)
    n_valid = torch.clamp_min(_per_sample(valid, B), 1.0)
    return _per_sample(per_edge * valid, B) / n_valid


def batched(fn):
    """The mean over the batch of a per-sample loss."""

    def wrapped(pred, sample, **kw):
        return torch.mean(fn(pred, sample, **kw))

    return wrapped
