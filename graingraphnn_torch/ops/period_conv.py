"""Periodic graph-transformer convolution (PeriodConv), fused across gates.

A UniMP-style graph transformer whose first three source features are
replaced per edge by the minimum-image displacement ``x_j[:3]-x_i[:3]``,
with values passed through a 2-layer MLP ``l2(relu(value(x_j')))``.

The plain version uses the algebraic shift decomposition: since key and
value are linear,
    key([reloc, x_j[3:]]) = K[j] + Wk_pos @ (shift - x_i[:3])
with ``K = key(x_j)`` a per-NODE projection and ``shift`` in {-1,0,1}^3 the
periodic wrap, so all input-width matmuls run once per node and the per-edge
work is a hidden-width gather plus a rank-3 correction.

Parameter layout per edge type (G = num_gates, C = out_channels), the JAX
package's own:
    key/query/value/skip: w [F, G*C], b [G*C]
    l2:   w [G, C, C], b [G, C]   (block-diagonal across gates)
    edge: w [G*C]                 (edge_dim is always 1)
Gate blocks are ordered [i, f, c, o] along the fused output axis.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..graph.geometry import wrap_shift
from ..kernels import edge_stage
from .segment import masked_softmax

POS_DIM = 3  # (x, y, z) leading feature columns carry node position


def _frozen(shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape), requires_grad=False)


class Dense(nn.Module):
    """Weight and bias in the JAX package's layout (w is [in, out])."""

    def __init__(self, w_shape, b_shape):
        super().__init__()
        self.w = _frozen(w_shape)
        self.b = _frozen(b_shape)


class EdgeWeight(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.w = _frozen((width,))


class PeriodConv(nn.Module):
    """Parameters of one fused-gate PeriodConv."""

    def __init__(self, in_src: int, in_dst: int, out_channels: int,
                 num_gates: int = 1):
        super().__init__()
        C, G = out_channels, num_gates
        self.num_gates, self.out_channels = G, C
        self.key = Dense((in_src, G * C), (G * C,))
        self.query = Dense((in_dst, G * C), (G * C,))
        self.value = Dense((in_src, G * C), (G * C,))
        self.skip = Dense((in_dst, G * C), (G * C,))
        self.l2 = Dense((G, C, C), (G, C))
        self.edge = EdgeWeight(G * C)


def apply_period_conv(conv: PeriodConv, x_src, x_dst, nbr, edge_len,
                      nbr_mask, *, num_gates: int, out_channels: int):
    """Fused-gate periodic conv. Returns [Nd, num_gates * out_channels].

    CPU tensors take the plain version below; CUDA tensors go to the hand
    kernel (kernels/edge_stage.py), which raises on what it cannot take."""
    if x_src.device.type == "cpu":
        return apply_period_conv_plain(
            conv, x_src, x_dst, nbr, edge_len, nbr_mask,
            num_gates=num_gates, out_channels=out_channels)
    return edge_stage.apply_period_conv_cuda(
        conv, x_src, x_dst, nbr, edge_len, nbr_mask,
        num_gates=num_gates, out_channels=out_channels)


def apply_period_conv_plain(conv: PeriodConv, x_src, x_dst, nbr, edge_len,
                            nbr_mask, *, num_gates: int, out_channels: int):
    """Plain PyTorch version (shift decomposition); the kernels' oracle:
    the node projections, then the edge stage on them."""
    return edge_attn_plain(
        conv, x_src, x_dst, nbr, edge_len, nbr_mask,
        node_projections_plain(conv, x_src, x_dst),
        num_gates=num_gates, out_channels=out_channels)


def node_projections_plain(conv: PeriodConv, x_src, x_dst):
    """The per-node projections (Kn, Vn [Ns, GC]; Q, Sk [Nd, GC]): the
    plain version of the node_proj kernel."""
    Q = x_dst @ conv.query.w + conv.query.b        # [Nd, GC]
    Kn = x_src @ conv.key.w + conv.key.b           # [Ns, GC]
    Vn = x_src @ conv.value.w + conv.value.b       # [Ns, GC]
    Sk = x_dst @ conv.skip.w + conv.skip.b         # [Nd, GC]
    return Kn, Vn, Q, Sk


def edge_attn_plain(conv: PeriodConv, x_src, x_dst, nbr, edge_len, nbr_mask,
                    proj, *, num_gates: int, out_channels: int):
    """The edge stage on the node projections proj = (Kn, Vn, Q, Sk): the
    plain version of the edge_attn kernel."""
    G, C = num_gates, out_channels
    Nd, K = nbr.shape
    nbr = nbr.long()
    Kn, Vn, Q, Sk = proj

    wk_pos = conv.key.w[:POS_DIM]                  # [3, GC]
    wv_pos = conv.value.w[:POS_DIM]
    Pk = x_dst[:, :POS_DIM] @ wk_pos               # [Nd, GC]
    Pv = x_dst[:, :POS_DIM] @ wv_pos

    # ---- edge stage: gathers + rank-3 shift correction ----
    rel = x_src[:, :POS_DIM][nbr] - x_dst[:, None, :POS_DIM]   # [Nd, K, 3]
    shift = wrap_shift(rel)

    e = edge_len[..., None] * conv.edge.w                       # [Nd, K, GC]
    k_e = Kn[nbr] - Pk[:, None, :] + shift @ wk_pos + e
    pre_v = Vn[nbr] - Pv[:, None, :] + shift @ wv_pos

    # 2-layer value MLP, block-diagonal across gates
    v = torch.einsum(
        "nkgc,gcd->nkgd", torch.relu(pre_v).reshape(Nd, K, G, C), conv.l2.w
    ) + conv.l2.b

    # ---- attention: per-gate logits, masked softmax over neighbor axis ----
    logits = torch.sum(
        Q.reshape(Nd, 1, G, C) * k_e.reshape(Nd, K, G, C), dim=-1
    ) / math.sqrt(C)                                            # [Nd, K, G]
    alpha = masked_softmax(logits, nbr_mask[..., None], dim=1)

    msg = (v + e.reshape(Nd, K, G, C)) * alpha[..., None]
    out = torch.sum(msg, dim=1).reshape(Nd, G * C)
    return out + Sk
