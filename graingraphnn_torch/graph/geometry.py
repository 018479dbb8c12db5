"""Periodic-domain geometry on the unit square (period 1): on tensors, and
the numpy helpers of the host topology editor (rollout.topology)."""

from __future__ import annotations

import numpy as np
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


def periodic_dist_np(p, pc) -> float:
    """periodic_dist of two host points, in float64."""
    rel = np.asarray(p, dtype=np.float64) - np.asarray(pc, dtype=np.float64)
    rel += -(rel > 0.5).astype(rel.dtype) + (rel < -0.5).astype(rel.dtype)
    return float(np.sqrt(np.sum(rel * rel)))


def point_in_triangle(t, v1, v2, v3) -> bool:
    """Whether host point t lies in the triangle (v1, v2, v3), each vertex
    moved to its periodic image nearest t; points on an edge are inside."""
    t = np.asarray(t, dtype=np.float64)

    def move(v):
        v = np.asarray(v, dtype=np.float64)
        rel = v - t
        return v - (rel > 0.5) + (rel < -0.5)

    def sign(a, b, c):
        return (a[0] - c[0]) * (b[1] - c[1]) - (b[0] - c[0]) * (a[1] - c[1])

    v1m, v2m, v3m = move(v1), move(v2), move(v3)
    d1 = sign(t, v1m, v2m)
    d2 = sign(t, v2m, v3m)
    d3 = sign(t, v3m, v1m)
    has_neg = (d1 < 0) or (d2 < 0) or (d3 < 0)
    has_pos = (d1 > 0) or (d2 > 0) or (d3 > 0)
    return not (has_neg and has_pos)


def in_bound(x, y, max_y: float = 1.0) -> bool:
    """Half-open unit-cell membership (0, 1] x (0, max_y], with 1e-12 of
    slack, used when deduplicating periodic Voronoi vertices."""
    return -1e-12 < x <= 1 + 1e-12 and -1e-12 < y <= max_y + 1e-12
