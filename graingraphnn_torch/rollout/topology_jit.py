"""Editor state and the per-span event budgets of the device-side topology
editor. The editor itself is kernels/editor_core.py (plain version) and
kernels/editor_fused.py (the CUDA kernel's wrapper)."""

from __future__ import annotations

import dataclasses

import torch

JOINT_SCALE = 5.0
RING_MAX = 16      # junction-ring capacity of one grain
MAX_SWITCH = 24    # neighbor-switching budget per span
MAX_ELIM = 8       # grain-elimination budget per span
MAX_TWOSIDED = 8   # two-sided-grain cleanup budget per pass
MAX_EXTRA = 2 * MAX_ELIM * (RING_MAX + 1)


@dataclasses.dataclass
class TopoState:
    E_pp: torch.Tensor       # [2, EP] int32 directed jj COO, -1 sentinels
    E_pq: torch.Tensor       # [2, EQ] int32 (joint, grain) COO
    xj: torch.Tensor         # [NJ, F] joint features (0:2 pos, 6:8 grads)
    y_joint: torch.Tensor    # [NJ, 2] predicted joint displacement
    mask_g: torch.Tensor     # [NG] int32
    mask_j: torch.Tensor     # [NJ] int32
    append_ptr: torch.Tensor  # [] int32: next free E_pp column
