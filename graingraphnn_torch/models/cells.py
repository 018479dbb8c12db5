"""Heterogeneous recurrent graph cells.

`PGCLSTM` (the fused-gate HeteroPGCLSTM, layer 0): a ConvLSTM on the grain
graph where each of the four gates (i, f, c~, o) is one periodic conv per
edge type, summed over the incoming edge types of each node type, plus a
per-node-type gate bias; the gate input is concat([x, h]). All four gates
read the same input and topology, so they run as ONE fused conv per edge
type with 4x-wide projections: three conv applications per cell step
(push g->j, connect j->j, pull j->g).

`SageCLSTM` is the cell of stacked layers >= 1: the same LSTM update on
fused-gate SAGE convolutions (mean over neighbors, no geometry). `PGC` is
the non-recurrent single-gate variant (ReLU, the cell state passes
through); no shipped model uses it.

Every apply function takes `kernels`, the conv formulation its caller
chose, and `precision` ("fp32" or "bf16"), its numerics
(ops.period_conv.apply_period_conv); the SAGE cells have no periodic conv
and take neither. With kernels, a PGCLSTM step on the card makes its
update (gate sums and biases, activations, new h and c of both node types)
in one launch of kernels/cell_update.py, which like the conv kernels has
no backward; its plain version is the torch formulation here
(_gate_update), which every other step takes.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch import nn

from ..graph.state import GraphSample
from ..kernels import cell_update
from ..ops.period_conv import (
    Dense,
    PeriodConv,
    apply_period_conv,
    glorot_uniform,
    init_period_conv,
)

GATE_ORDER = ("i", "f", "c", "o")
NUM_GATES = len(GATE_ORDER)
EDGE_KEYS = ("push", "pull", "connect")  # src->dst: g->j, j->g, j->j


def _gate_bias(num_gates: int, C: int) -> nn.ParameterDict:
    return nn.ParameterDict({k: nn.Parameter(torch.zeros(num_gates, C))
                             for k in ("grain", "joint")})


@torch.no_grad()
def _init_gate_bias(bias: nn.ParameterDict, generator: torch.Generator):
    """glorot([1, C]) per gate row, grain then joint."""
    for k in ("grain", "joint"):
        G, C = bias[k].shape
        bias[k].copy_(glorot_uniform((G, C), 1, C, generator))


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
        self.bias = _gate_bias(NUM_GATES, C)


def init_pgclstm(cell, generator: torch.Generator):
    """Glorot convs (push, pull, connect) and gate biases, in place; also
    initialises a PGC cell. Returns cell."""
    for k in EDGE_KEYS:
        init_period_conv(cell.conv[k], generator)
    _init_gate_bias(cell.bias, generator)
    return cell


def _lstm_update(gates: torch.Tensor, c: torch.Tensor, C: int):
    """gates: [N, 4C] in gate order (i, f, c~, o)."""
    i = torch.sigmoid(gates[:, 0 * C : 1 * C])
    f = torch.sigmoid(gates[:, 1 * C : 2 * C])
    g = torch.tanh(gates[:, 2 * C : 3 * C])
    o = torch.sigmoid(gates[:, 3 * C : 4 * C])
    c_new = f * c + i * g
    h_new = o * torch.tanh(c_new)
    return h_new, c_new


def _gate_update(msgs, bias, c, C: int):
    """One node type's update in the torch formulation, the plain version
    of kernels/cell_update.py: its messages summed in their order, plus its
    gate bias [4, C], then _lstm_update; c None is the zero state."""
    gates = msgs[0]
    for m in msgs[1:]:
        gates = gates + m
    gates = gates + bias.reshape(-1)
    if c is None:
        c = gates.new_zeros((gates.shape[0], C))
    return _lstm_update(gates, c, C)


def _sources(xg, xj, src_gather):
    """The source node tables of the convs: (xg, xj) themselves, or
    src_gather(xg, xj) where the node rows are split over ranks (the halo
    stripes' [left | local | right] tables, parallel.halo)."""
    return (xg, xj) if src_gather is None else src_gather(xg, xj)


def _period_convs(cell, sample, xg, xj, num_gates, C, kernels,
                  src_gather=None, precision="fp32"):
    """(push, connect) into joints and pull into grains of a periodic
    cell."""
    kw = dict(num_gates=num_gates, out_channels=C, kernels=kernels,
              precision=precision)
    s = sample
    xg_src, xj_src = _sources(xg, xj, src_gather)
    out_push = apply_period_conv(cell.conv["push"], xg_src, xj, s.push_nbr,
                                 s.push_len, s.push_mask, **kw)
    out_connect = apply_period_conv(cell.conv["connect"], xj_src, xj,
                                    s.connect_nbr, s.connect_len,
                                    s.connect_mask, **kw)
    out_pull = apply_period_conv(cell.conv["pull"], xj_src, xg, s.pull_nbr,
                                 s.pull_len, s.pull_mask, **kw)
    return out_push, out_connect, out_pull


def _gate_inputs(grain_in, joint_in, h):
    xg = torch.cat([grain_in, h["grain"]], dim=1).contiguous()
    xj = torch.cat([joint_in, h["joint"]], dim=1).contiguous()
    return xg, xj


def apply_pgclstm(
    cell: PGCLSTM,
    sample: GraphSample,
    grain_in: torch.Tensor,
    joint_in: torch.Tensor,
    state: Tuple[Dict, Dict],
    out_channels: int,
    *,
    kernels: bool,
    src_gather=None,
    precision: str = "fp32",
):
    """One recurrent step. state = (h, c), each {'grain': [NG,C],
    'joint': [NJ,C]}. src_gather(xg, xj) -> (xg_src, xj_src) makes the
    convs' source tables where node rows are split over ranks; None on
    one device."""
    C = out_channels
    h, c = state
    xg, xj = _gate_inputs(grain_in, joint_in, h)
    out_push, out_connect, out_pull = _period_convs(
        cell, sample, xg, xj, NUM_GATES, C, kernels, src_gather, precision)
    b = cell.bias
    joint = ((out_push, out_connect), b["joint"], c["joint"])
    grain = ((out_pull,), b["grain"], c["grain"])
    if kernels and out_push.device.type == "cuda":
        (h_j, c_j), (h_g, c_g) = cell_update.cell_update_cuda(joint, grain,
                                                              C)
    else:
        h_g, c_g = _gate_update(*grain, C)
        h_j, c_j = _gate_update(*joint, C)
    return {"grain": h_g, "joint": h_j}, {"grain": c_g, "joint": c_j}


# ---------------------------------------------------------------------------
# SAGE cell for stacked layers >= 1
# ---------------------------------------------------------------------------


class SageConv(nn.Module):
    """Fused-gate SAGEConv: out = l(mean_j x_j) + x_i @ r.w. r.b is kept
    (zeros, never read) as in the JAX package's tree."""

    def __init__(self, in_src: int, in_dst: int, out_channels: int,
                 num_gates: int):
        super().__init__()
        GC = num_gates * out_channels
        self.num_gates, self.out_channels = num_gates, out_channels
        self.l = Dense((in_src, GC), (GC,))
        self.r = Dense((in_dst, GC), (GC,))


def torch_linear_init(dense: Dense, generator: torch.Generator, bias=True):
    """torch.nn.Linear's default init: U(-1/sqrt(fan_in), 1/sqrt(fan_in))
    for weight and bias (zero bias when bias=False); in place."""
    fan_in = dense.w.shape[0]
    bound = 1.0 / math.sqrt(fan_in) if fan_in > 0 else 0.0
    with torch.no_grad():
        dense.w.uniform_(-bound, bound, generator=generator)
        if bias:
            dense.b.uniform_(-bound, bound, generator=generator)
        else:
            dense.b.zero_()
    return dense


@torch.no_grad()
def init_sage_conv(conv: SageConv, generator: torch.Generator):
    """Each gate block a torch Linear of its own: l with bias, r without."""
    G, C = conv.num_gates, conv.out_channels
    for dense, bias in ((conv.l, True), (conv.r, False)):
        fan_in = dense.w.shape[0]
        blocks = [torch_linear_init(Dense((fan_in, C), (C,)), generator, bias)
                  for _ in range(G)]
        dense.w.copy_(torch.cat([b.w for b in blocks], dim=1))
        dense.b.copy_(torch.cat([b.b for b in blocks]))
    return conv


def apply_sage_conv(conv: SageConv, x_src, x_dst, nbr, nbr_mask):
    deg = torch.sum(nbr_mask, dim=1, keepdim=True)
    nb = x_src.index_select(0, nbr.reshape(-1).long()).reshape(
        tuple(nbr.shape) + (x_src.shape[1],))
    mean_nbr = torch.sum(nb * nbr_mask[..., None], dim=1) / torch.clamp_min(
        deg, 1.0)
    return mean_nbr @ conv.l.w + conv.l.b + x_dst @ conv.r.w


class SageCLSTM(nn.Module):
    def __init__(self, in_grain: int, in_joint: int, out_channels: int):
        super().__init__()
        C = out_channels
        fg, fj = in_grain + C, in_joint + C
        self.conv = nn.ModuleDict({
            "push": SageConv(fg, fj, C, NUM_GATES),
            "pull": SageConv(fj, fg, C, NUM_GATES),
            "connect": SageConv(fj, fj, C, NUM_GATES),
        })
        self.bias = _gate_bias(NUM_GATES, C)


def init_sage_clstm(cell: SageCLSTM, generator: torch.Generator):
    for k in EDGE_KEYS:
        init_sage_conv(cell.conv[k], generator)
    _init_gate_bias(cell.bias, generator)
    return cell


def apply_sage_clstm(cell: SageCLSTM, sample, grain_in, joint_in, state,
                     out_channels, src_gather=None):
    C = out_channels
    h, c = state
    xg, xj = _gate_inputs(grain_in, joint_in, h)
    s = sample
    xg_src, xj_src = _sources(xg, xj, src_gather)
    out_push = apply_sage_conv(cell.conv["push"], xg_src, xj, s.push_nbr,
                               s.push_mask)
    out_connect = apply_sage_conv(cell.conv["connect"], xj_src, xj,
                                  s.connect_nbr, s.connect_mask)
    out_pull = apply_sage_conv(cell.conv["pull"], xj_src, xg, s.pull_nbr,
                               s.pull_mask)
    joint_gates = out_push + out_connect + cell.bias["joint"].reshape(-1)
    grain_gates = out_pull + cell.bias["grain"].reshape(-1)
    h_g, c_g = _lstm_update(grain_gates, c["grain"], C)
    h_j, c_j = _lstm_update(joint_gates, c["joint"], C)
    return {"grain": h_g, "joint": h_j}, {"grain": c_g, "joint": c_j}


# ---------------------------------------------------------------------------
# Non-recurrent single-gate periodic cell
# ---------------------------------------------------------------------------


class PGC(nn.Module):
    def __init__(self, in_grain: int, in_joint: int, out_channels: int):
        super().__init__()
        C = out_channels
        fg, fj = in_grain + C, in_joint + C
        self.conv = nn.ModuleDict({
            "push": PeriodConv(fg, fj, C, 1),
            "pull": PeriodConv(fj, fg, C, 1),
            "connect": PeriodConv(fj, fj, C, 1),
        })
        self.bias = _gate_bias(1, C)


def apply_pgc(cell: PGC, sample, grain_in, joint_in, state, out_channels, *,
              kernels: bool, precision: str = "fp32"):
    """h = relu(conv(cat([x, h])) + b); the cell state passes through."""
    C = out_channels
    h, c = state
    xg, xj = _gate_inputs(grain_in, joint_in, h)
    out_push, out_connect, out_pull = _period_convs(
        cell, sample, xg, xj, 1, C, kernels, precision=precision)
    h_j = torch.relu(out_push + out_connect + cell.bias["joint"].reshape(-1))
    h_g = torch.relu(out_pull + cell.bias["grain"].reshape(-1))
    return {"grain": h_g, "joint": h_j}, c


def apply_cell(cell, sample, grain_in, joint_in, state, out_channels, *,
               kind: str, kernels: bool, src_gather=None,
               precision: str = "fp32"):
    """kind is static config ('pgclstm' for layer 0, 'sage' for layers >= 1,
    HyperParams.cell_kinds)."""
    if kind == "pgclstm":
        return apply_pgclstm(cell, sample, grain_in, joint_in, state,
                             out_channels, kernels=kernels,
                             src_gather=src_gather, precision=precision)
    return apply_sage_clstm(cell, sample, grain_in, joint_in, state,
                            out_channels, src_gather)


def zero_state(sample: GraphSample, out_channels: int):
    """Zero-initialised (h, c) per node type."""
    def z(x):
        return x.new_zeros((x.shape[0], out_channels))

    h = {"grain": z(sample.grain_x), "joint": z(sample.joint_x)}
    c = {k: v.clone() for k, v in h.items()}
    return h, c
