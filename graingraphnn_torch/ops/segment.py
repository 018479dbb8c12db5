"""Masked softmax over a static neighbor axis (the ELL message-passing
normalisation)."""

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
