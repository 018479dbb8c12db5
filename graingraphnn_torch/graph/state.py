"""Fixed-capacity, mask-padded graph sample (destination-major ELL adjacency).

Node arrays are padded to fixed capacities with 0/1 live masks; every
junction has exactly 3 junction and 3 grain neighbors, and each grain keeps
a fixed-capacity ring of junctions, so segment softmax and segment sum are
dense masked reductions over a static neighbor axis.

The training targets, `build_sample` and `stack` wait for the training port.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass
class GraphSample:
    """One padded heterogeneous grain graph, as the rollout's forward reads
    it."""

    grain_x: torch.Tensor     # [NG, 11] float32
    joint_x: torch.Tensor     # [NJ, 8] float32
    grain_mask: torch.Tensor  # [NG] float32
    joint_mask: torch.Tensor  # [NJ] float32

    # ('grain','push','joint'): the 3 grain neighbors feeding each junction
    push_nbr: torch.Tensor    # [NJ, 3] int32
    push_len: torch.Tensor    # [NJ, 3] float32
    push_mask: torch.Tensor   # [NJ, 3] float32
    # ('joint','connect','joint'): the 3 junction neighbors of each junction
    connect_nbr: torch.Tensor
    connect_len: torch.Tensor
    connect_mask: torch.Tensor
    # ('joint','pull','grain'): the ring of junctions around each grain
    pull_nbr: torch.Tensor    # [NG, K] int32
    pull_len: torch.Tensor
    pull_mask: torch.Tensor

    # directed joint-joint COO edges (classifier pair head)
    jj_src: torch.Tensor   # [E] int32
    jj_dst: torch.Tensor   # [E] int32
    jj_len: torch.Tensor   # [E] float32
    jj_mask: torch.Tensor  # [E] float32


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple
