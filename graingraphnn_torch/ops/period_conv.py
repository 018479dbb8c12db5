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
from .segment import masked_softmax, segment_softmax, segment_sum

POS_DIM = 3  # (x, y, z) leading feature columns carry node position


class Dense(nn.Module):
    """Weight and bias in the JAX package's layout (w is [in, out])."""

    def __init__(self, w_shape, b_shape):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(w_shape))
        self.b = nn.Parameter(torch.zeros(b_shape))


class EdgeWeight(nn.Module):
    def __init__(self, width: int):
        super().__init__()
        self.w = nn.Parameter(torch.zeros(width))


class PeriodConv(nn.Module):
    """Parameters of one fused-gate PeriodConv (zeros until initialised
    by init_period_conv or loaded)."""

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


def glorot_uniform(shape, fan_in: int, fan_out: int,
                   generator: torch.Generator) -> torch.Tensor:
    """U(-limit, limit) with limit = sqrt(6 / (fan_in + fan_out))."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return torch.empty(shape).uniform_(-limit, limit, generator=generator)


@torch.no_grad()
def init_period_conv(conv: PeriodConv, generator: torch.Generator):
    """Glorot init per gate block (each gate's [fan_in, C] block and [C, C]
    l2 block drawn on its own), zero biases; in place, returns conv."""
    G, C = conv.num_gates, conv.out_channels

    def fused(fan_in):
        return torch.cat([glorot_uniform((fan_in, C), fan_in, C, generator)
                          for _ in range(G)], dim=1)

    conv.key.w.copy_(fused(conv.key.w.shape[0]))
    conv.query.w.copy_(fused(conv.query.w.shape[0]))
    conv.value.w.copy_(fused(conv.value.w.shape[0]))
    conv.l2.w.copy_(torch.stack([glorot_uniform((C, C), C, C, generator)
                                 for _ in range(G)]))
    conv.edge.w.copy_(torch.cat([glorot_uniform((C,), 1, C, generator)
                                 for _ in range(G)]))
    conv.skip.w.copy_(fused(conv.skip.w.shape[0]))
    for d in (conv.key, conv.query, conv.value, conv.skip, conv.l2):
        d.b.zero_()
    return conv


def apply_period_conv(conv: PeriodConv, x_src, x_dst, nbr, edge_len,
                      nbr_mask, *, num_gates: int, out_channels: int,
                      kernels: bool, attention: bool = True):
    """Fused-gate periodic conv. Returns [Nd, num_gates * out_channels].

    kernels=True takes the hand kernels (kernels/edge_stage.py) for CUDA
    tensors, as the rollout and evaluation forwards do; the kernels have no
    backward and raise under autograd. kernels=False takes the torch
    formulation below, which autograd differentiates (the training step).
    CPU tensors always take the torch formulation, and so does
    attention=False: plain masked sums over the neighbors, the reference's
    ablation twin."""
    if kernels and attention and x_src.device.type == "cuda":
        return edge_stage.apply_period_conv_cuda(
            conv, x_src, x_dst, nbr, edge_len, nbr_mask,
            num_gates=num_gates, out_channels=out_channels)
    return apply_period_conv_plain(
        conv, x_src, x_dst, nbr, edge_len, nbr_mask,
        num_gates=num_gates, out_channels=out_channels, attention=attention)


def apply_period_conv_plain(conv: PeriodConv, x_src, x_dst, nbr, edge_len,
                            nbr_mask, *, num_gates: int, out_channels: int,
                            attention: bool = True):
    """Plain PyTorch version (shift decomposition); the kernels' oracle:
    the node projections, then the edge stage on them."""
    return edge_attn_plain(
        conv, x_src, x_dst, nbr, edge_len, nbr_mask,
        node_projections_plain(conv, x_src, x_dst),
        num_gates=num_gates, out_channels=out_channels, attention=attention)


def node_projections_plain(conv: PeriodConv, x_src, x_dst):
    """The per-node projections (Kn, Vn [Ns, GC]; Q, Sk [Nd, GC]): the
    plain version of the node_proj kernel."""
    Q = x_dst @ conv.query.w + conv.query.b        # [Nd, GC]
    Kn = x_src @ conv.key.w + conv.key.b           # [Ns, GC]
    Vn = x_src @ conv.value.w + conv.value.b       # [Ns, GC]
    Sk = x_dst @ conv.skip.w + conv.skip.b         # [Nd, GC]
    return Kn, Vn, Q, Sk


def _gather(table, idx):
    """table[idx] for an index array idx [Nd, K] (index_select, whose
    backward is one index_add)."""
    return table.index_select(0, idx.reshape(-1)).reshape(
        tuple(idx.shape) + tuple(table.shape[1:]))


def edge_attn_plain(conv: PeriodConv, x_src, x_dst, nbr, edge_len, nbr_mask,
                    proj, *, num_gates: int, out_channels: int,
                    attention: bool = True):
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
    rel = _gather(x_src[:, :POS_DIM], nbr) - x_dst[:, None, :POS_DIM]  # [Nd,K,3]
    shift = wrap_shift(rel)

    e = edge_len[..., None] * conv.edge.w                       # [Nd, K, GC]
    k_e = _gather(Kn, nbr) - Pk[:, None, :] + shift @ wk_pos + e
    pre_v = _gather(Vn, nbr) - Pv[:, None, :] + shift @ wv_pos

    # 2-layer value MLP, block-diagonal across gates
    v = torch.einsum(
        "nkgc,gcd->nkgd", torch.relu(pre_v).reshape(Nd, K, G, C), conv.l2.w
    ) + conv.l2.b

    # ---- attention: per-gate logits, masked softmax over neighbor axis ----
    if attention:
        logits = torch.sum(
            Q.reshape(Nd, 1, G, C) * k_e.reshape(Nd, K, G, C), dim=-1
        ) / math.sqrt(C)                                        # [Nd, K, G]
        alpha = masked_softmax(logits, nbr_mask[..., None], dim=1)
    else:
        alpha = nbr_mask[..., None].expand(Nd, K, G)

    msg = (v + e.reshape(Nd, K, G, C)) * alpha[..., None]
    out = torch.sum(msg, dim=1).reshape(Nd, G * C)
    return out + Sk


def apply_period_conv_coo_reference(conv: PeriodConv, x_src, x_dst, src, dst,
                                    edge_len, edge_mask, *, num_gates: int,
                                    out_channels: int):
    """The naive per-edge formulation over a COO edge list src -> dst [E]:
    relocated source features, per-edge projections, segment softmax per
    destination. For tests only: it holds the shift decomposition to the
    conv's definition."""
    G, C = num_gates, out_channels
    Nd = x_dst.shape[0]
    src, dst = src.long(), dst.long()
    x_j, x_i = x_src[src], x_dst[dst]
    rel = x_j[:, :POS_DIM] - x_i[:, :POS_DIM]
    x_jp = torch.cat([rel + wrap_shift(rel), x_j[:, POS_DIM:]], dim=1)

    q = x_i @ conv.query.w + conv.query.b
    k = x_jp @ conv.key.w + conv.key.b
    v1 = x_jp @ conv.value.w + conv.value.b
    v = torch.einsum("egc,gcd->egd", torch.relu(v1).reshape(-1, G, C),
                     conv.l2.w) + conv.l2.b
    e = edge_len[:, None] * conv.edge.w
    k = k + e
    logits = torch.sum(q.reshape(-1, G, C) * k.reshape(-1, G, C),
                       dim=-1) / math.sqrt(C)
    alpha = torch.stack([segment_softmax(logits[:, g], dst, Nd, mask=edge_mask)
                         for g in range(G)], dim=-1)             # [E, G]
    msg = (v + e.reshape(-1, G, C)) * alpha[..., None] * edge_mask[:, None, None]
    agg = segment_sum(msg.reshape(-1, G * C), dst, Nd)
    return agg + x_dst @ conv.skip.w + conv.skip.b
