"""Masked segment primitives.

* `masked_softmax` over a static neighbor axis: the ELL message-passing
  normalisation of the hot path.
* COO `segment_sum` / `segment_softmax` over a per-edge list: the naive
  per-edge formulation the COO reference conv is built from.
"""

from __future__ import annotations

import torch

_NEG_INF = -1e30


def masked_softmax(logits: torch.Tensor, mask: torch.Tensor, dim: int = -1):
    """Softmax over `dim` where mask==0 entries get zero weight. Rows with no
    valid entries return all zeros (no NaNs)."""
    valid = mask > 0
    masked_logits = torch.where(valid, logits, torch.full_like(logits, _NEG_INF))
    m = torch.amax(masked_logits, dim=dim, keepdim=True)
    # guard fully-masked rows: max == -inf -> shift by 0 instead
    m = torch.where(m <= _NEG_INF / 2, torch.zeros_like(m), m)
    e = torch.where(valid, torch.exp(masked_logits - m), torch.zeros_like(logits))
    denom = torch.sum(e, dim=dim, keepdim=True)
    return e / torch.clamp_min(denom, 1e-30)


def segment_sum(values: torch.Tensor, segment_ids: torch.Tensor,
                num_segments: int):
    """Scatter-add of the rows of `values` [E, ...] into num_segments rows."""
    out = values.new_zeros((num_segments,) + tuple(values.shape[1:]))
    return out.index_add(0, segment_ids.long(), values)


def segment_softmax(logits: torch.Tensor, segment_ids: torch.Tensor,
                    num_segments: int, mask: torch.Tensor | None = None):
    """Softmax of the per-edge `logits` [E] over the edges of each
    destination segment; masked edges get zero weight, and a segment with
    no live edge gives no NaN."""
    ids = segment_ids.long()
    if mask is not None:
        logits = torch.where(mask > 0, logits, torch.full_like(logits, _NEG_INF))
    seg_max = logits.new_full((num_segments,), _NEG_INF).scatter_reduce(
        0, ids, logits, reduce="amax", include_self=False)
    seg_max = torch.where(seg_max <= _NEG_INF / 2, torch.zeros_like(seg_max),
                          seg_max)
    e = torch.exp(logits - seg_max[ids])
    if mask is not None:
        e = torch.where(mask > 0, e, torch.zeros_like(e))
    denom = segment_sum(e, ids, num_segments)
    return e / torch.clamp_min(denom[ids], 1e-30)
