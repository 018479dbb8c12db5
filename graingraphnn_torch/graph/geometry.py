"""Periodic-domain geometry on the unit square (period 1), on tensors."""

from __future__ import annotations

import torch


def wrap_shift(rel: torch.Tensor) -> torch.Tensor:
    """Integer lattice shift in {-1, 0, +1} that maps `rel` to its minimum
    image: shift = -1*(rel>0.5) + 1*(rel<-0.5)."""
    return -(rel > 0.5).to(rel.dtype) + (rel < -0.5).to(rel.dtype)


def min_image(rel: torch.Tensor) -> torch.Tensor:
    """Minimum-image displacement for coordinates in a period-1 domain."""
    return rel + wrap_shift(rel)


def periodic_dist(p: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
    """Euclidean distance with minimum-image wraparound."""
    rel = min_image(p - pc)
    return torch.sqrt(torch.sum(rel * rel, dim=-1))


def periodic_move(p: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
    """Shift point(s) `p` by whole periods so they lie in the same image as
    `pc`."""
    return p + wrap_shift(p - pc)


def periodic_unit(p: torch.Tensor, pc: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """Unit vector from `pc` toward `p` under minimum image."""
    rel = min_image(p - pc)
    norm = torch.sqrt(torch.sum(rel * rel, dim=-1, keepdim=True))
    return rel / torch.clamp_min(norm, eps)
