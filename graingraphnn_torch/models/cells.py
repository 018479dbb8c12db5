"""Heterogeneous recurrent graph cell (fused-gate HeteroPGCLSTM).

A ConvLSTM on the grain graph: each of the four gates (i, f, c~, o) is one
periodic conv per edge type, summed over the incoming edge types of each
node type, plus a per-node-type gate bias; the gate input is
concat([x, h]). All four gates read the same input and topology, so they
run as ONE fused conv per edge type with 4x-wide projections: three conv
applications per cell step (push g->j, connect j->j, pull j->g).

The SAGE and non-recurrent cells wait for a later slice: the shipped
checkpoints use one layer, which is always this cell.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..graph.state import GraphSample
from ..ops.period_conv import PeriodConv, apply_period_conv

GATE_ORDER = ("i", "f", "c", "o")
NUM_GATES = len(GATE_ORDER)


class PGCLSTM(nn.Module):
    """Parameters of one layer-0 cell. Conv fan-in is in_* + C because the
    gate input is concat([x, h])."""

    def __init__(self, in_grain: int, in_joint: int, out_channels: int):
        super().__init__()
        C = out_channels
        fg, fj = in_grain + C, in_joint + C
        self.conv = nn.ModuleDict({
            "push": PeriodConv(fg, fj, C, NUM_GATES),
            "pull": PeriodConv(fj, fg, C, NUM_GATES),
            "connect": PeriodConv(fj, fj, C, NUM_GATES),
        })
        self.bias = nn.ParameterDict({
            k: nn.Parameter(torch.zeros(NUM_GATES, C), requires_grad=False)
            for k in ("grain", "joint")
        })


def _lstm_update(gates: torch.Tensor, c: torch.Tensor, C: int):
    """gates: [N, 4C] in gate order (i, f, c~, o)."""
    i = torch.sigmoid(gates[:, 0 * C : 1 * C])
    f = torch.sigmoid(gates[:, 1 * C : 2 * C])
    g = torch.tanh(gates[:, 2 * C : 3 * C])
    o = torch.sigmoid(gates[:, 3 * C : 4 * C])
    c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    return h_new, c_new


def apply_pgclstm(
    cell: PGCLSTM,
    sample: GraphSample,
    grain_in: torch.Tensor,
    joint_in: torch.Tensor,
    state: Tuple[Dict, Dict],
    out_channels: int,
):
    """One recurrent step. state = (h, c), each {'grain': [NG,C],
    'joint': [NJ,C]}."""
    C = out_channels
    h, c = state
    xg = torch.cat([grain_in, h["grain"]], dim=1).contiguous()
    xj = torch.cat([joint_in, h["joint"]], dim=1).contiguous()

    kw = dict(num_gates=NUM_GATES, out_channels=C)
    out_push = apply_period_conv(
        cell.conv["push"], xg, xj, sample.push_nbr, sample.push_len,
        sample.push_mask, **kw,
    )
    out_connect = apply_period_conv(
        cell.conv["connect"], xj, xj, sample.connect_nbr,
        sample.connect_len, sample.connect_mask, **kw,
    )
    out_pull = apply_period_conv(
        cell.conv["pull"], xj, xg, sample.pull_nbr, sample.pull_len,
        sample.pull_mask, **kw,
    )

    joint_gates = out_push + out_connect + cell.bias["joint"].reshape(-1)
    grain_gates = out_pull + cell.bias["grain"].reshape(-1)

    h_g, c_g = _lstm_update(grain_gates, c["grain"], C)
    h_j, c_j = _lstm_update(joint_gates, c["joint"], C)
    return {"grain": h_g, "joint": h_j}, {"grain": c_g, "joint": c_j}


def zero_state(sample: GraphSample, out_channels: int):
    """Zero-initialised (h, c) per node type."""
    def z(x):
        return x.new_zeros((x.shape[0], out_channels))

    h = {"grain": z(sample.grain_x), "joint": z(sample.joint_x)}
    c = {k: v.clone() for k, v in h.items()}
    return h, c
