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
from ..utils import profiling
from .segment import masked_softmax, segment_softmax, segment_sum

POS_DIM = 3  # (x, y, z) leading feature columns carry node position
PRECISIONS = ("fp32", "bf16")


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


@profiling.span("graingnn.conv")
def apply_period_conv(conv: PeriodConv, x_src, x_dst, nbr, edge_len,
                      nbr_mask, *, num_gates: int, out_channels: int,
                      kernels: bool, attention: bool = True,
                      precision: str = "fp32"):
    """Fused-gate periodic conv. Returns [Nd, num_gates * out_channels].

    kernels=True takes the hand kernels (kernels/edge_stage.py) for CUDA
    tensors, as the rollout and evaluation forwards do; the kernels have no
    backward and raise under autograd. kernels=False takes the torch
    formulation below, which autograd differentiates (the training step).
    CPU tensors always take the torch formulation, and so does
    attention=False: plain masked sums over the neighbors, the reference's
    ablation twin.

    precision="bf16" takes the JAX package's bf16 numerics of the
    formulation chosen, in place of its two module globals: with kernels,
    the TPU kernel's at its default bf16 operands (use_pallas_kernels(True,
    bf16); the bf16 kernels on the card, their plain version on the CPU);
    without, the XLA formulation's under set_compute_dtype(bf16)
    (apply_period_conv_mixed). As in JAX, attention=False with kernels
    stays fp32."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision {precision!r}: one of {PRECISIONS}")
    kw = dict(num_gates=num_gates, out_channels=out_channels)
    if kernels and attention:
        if x_src.device.type == "cuda":
            return edge_stage.apply_period_conv_cuda(
                conv, x_src, x_dst, nbr, edge_len, nbr_mask,
                precision=precision, **kw)
        return apply_period_conv_plain(conv, x_src, x_dst, nbr, edge_len,
                                       nbr_mask, precision=precision, **kw)
    if precision == "bf16" and not kernels:
        return apply_period_conv_mixed(conv, x_src, x_dst, nbr, edge_len,
                                       nbr_mask, attention=attention, **kw)
    return apply_period_conv_plain(conv, x_src, x_dst, nbr, edge_len,
                                   nbr_mask, attention=attention, **kw)


def apply_period_conv_plain(conv: PeriodConv, x_src, x_dst, nbr, edge_len,
                            nbr_mask, *, num_gates: int, out_channels: int,
                            attention: bool = True, precision: str = "fp32"):
    """Plain PyTorch version (shift decomposition); the kernels' oracle:
    the node projections, then the edge stage on them. precision="bf16"
    (attention only) is the bf16 kernels' oracle."""
    return edge_attn_plain(
        conv, x_src, x_dst, nbr, edge_len, nbr_mask,
        node_projections_plain(conv, x_src, x_dst, precision),
        num_gates=num_gates, out_channels=out_channels, attention=attention,
        precision=precision)


def bf16_round(t: torch.Tensor) -> torch.Tensor:
    """t rounded to bfloat16 (to nearest, ties to even, as XLA's astype and
    __float2bfloat16_rn do), in t's dtype."""
    return t.to(torch.bfloat16).to(t.dtype)


def node_projections_plain(conv: PeriodConv, x_src, x_dst,
                           precision: str = "fp32"):
    """The per-node projections (Kn, Vn [Ns, GC]; Q, Sk [Nd, GC]): the
    plain version of the node_proj kernel.

    precision="bf16": inputs and weights rounded to bf16, products summed
    in fp32, biases fp32, as the TPU kernel's projections; Kn and Vn leave
    out the position lanes (x_src[:, :3] times Wk[:3] and Wv[:3]), which
    the edge stage adds per edge from the relocated positions."""
    if precision == "bf16":
        r, p = bf16_round, POS_DIM
        xs, xd = r(x_src[:, p:]), r(x_dst)
        return (xs @ r(conv.key.w[p:]) + conv.key.b,
                xs @ r(conv.value.w[p:]) + conv.value.b,
                xd @ r(conv.query.w) + conv.query.b,
                xd @ r(conv.skip.w) + conv.skip.b)
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
                    attention: bool = True, precision: str = "fp32"):
    """The edge stage on the node projections proj = (Kn, Vn, Q, Sk): the
    plain version of the edge_attn kernel (precision="bf16": of the
    edge_attn_bf16 kernel, on node_projections_plain(..., "bf16"))."""
    G, C = num_gates, out_channels
    if precision == "bf16":
        if not attention:
            raise ValueError("the bf16 edge stage is the attention conv's")
        return _edge_attn_plain_bf16(conv, x_src, x_dst, nbr, edge_len,
                                     nbr_mask, proj, G, C)
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


def _edge_attn_plain_bf16(conv, x_src, x_dst, nbr, edge_len, nbr_mask, proj,
                          G, C):
    """The TPU kernel's function at bf16 operands (kernels/edge_stage.py of
    the JAX package, _kernel and _kernel_flat), per edge, on the bf16 node
    projections. Rounded to bf16, as there: the relocated positions
    bf16(bf16(x_j) - bf16(x_i) + wrap), Wk[:3], Wv[:3] and Wl2, each
    product q * k_e before the per-gate sum, relu(pre_v) before the l2
    product, and alpha after the division. Everything else is fp32."""
    r = bf16_round
    Nd, K = nbr.shape
    nbr = nbr.long()
    Kn, Vn, Q, Sk = proj
    rel = (_gather(r(x_src[:, :POS_DIM]), nbr)
           - r(x_dst[:, None, :POS_DIM]))                     # [Nd, K, 3]
    xjp = r(rel + wrap_shift(rel))
    e = edge_len[..., None] * conv.edge.w                      # [Nd, K, GC]
    k_e = _gather(Kn, nbr) + xjp @ r(conv.key.w[:POS_DIM]) + e
    pre_v = _gather(Vn, nbr) + xjp @ r(conv.value.w[:POS_DIM])
    logits = torch.sum(r(Q.reshape(Nd, 1, G, C) * k_e.reshape(Nd, K, G, C)),
                       dim=-1) * (1.0 / math.sqrt(C))          # [Nd, K, G]
    alpha = r(masked_softmax(logits, nbr_mask[..., None], dim=1))
    v = torch.einsum("nkgc,gcd->nkgd", r(torch.relu(pre_v)).reshape(
        Nd, K, G, C), r(conv.l2.w)) + conv.l2.b
    msg = (v + e.reshape(Nd, K, G, C)) * alpha[..., None]
    return torch.sum(msg, dim=1).reshape(Nd, G * C) + Sk


def apply_period_conv_mixed(conv: PeriodConv, x_src, x_dst, nbr, edge_len,
                            nbr_mask, *, num_gates: int, out_channels: int,
                            attention: bool = True):
    """The torch formulation in mixed precision: the JAX package's XLA
    conv under set_compute_dtype(jnp.bfloat16), differentiable. Inputs,
    edge lengths and every parameter are cast to bf16 and the projections,
    gathers, shift corrections and logit products run in bf16; the l2
    product accumulates in fp32, and the logit sums, the softmax and the
    message sum are fp32, at the same points as there."""
    G, C = num_gates, out_channels
    Nd, K = nbr.shape
    nbr = nbr.long()
    bf = torch.bfloat16
    xs, xd, ln = x_src.to(bf), x_dst.to(bf), edge_len.to(bf)

    def dense(d, x):
        return x @ d.w.to(bf) + d.b.to(bf)

    Q, Sk = dense(conv.query, xd), dense(conv.skip, xd)
    Kn, Vn = dense(conv.key, xs), dense(conv.value, xs)
    wk_pos = conv.key.w[:POS_DIM].to(bf)
    wv_pos = conv.value.w[:POS_DIM].to(bf)
    Pk = xd[:, :POS_DIM] @ wk_pos
    Pv = xd[:, :POS_DIM] @ wv_pos
    rel = _gather(xs[:, :POS_DIM], nbr) - xd[:, None, :POS_DIM]
    shift = wrap_shift(rel)
    e = ln[..., None] * conv.edge.w.to(bf)
    k_e = _gather(Kn, nbr) - Pk[:, None, :] + shift @ wk_pos + e
    pre_v = _gather(Vn, nbr) - Pv[:, None, :] + shift @ wv_pos
    # bf16 operands are exact in fp32: an fp32 product is JAX's bf16 dot
    # with preferred_element_type=float32
    v = torch.einsum("nkgc,gcd->nkgd",
                     torch.relu(pre_v).reshape(Nd, K, G, C).float(),
                     conv.l2.w.to(bf).float()) + conv.l2.b.to(bf)
    if attention:
        logits = torch.sum(
            (Q.reshape(Nd, 1, G, C) * k_e.reshape(Nd, K, G, C)).float(),
            dim=-1) / math.sqrt(C)
        alpha = masked_softmax(logits, nbr_mask[..., None], dim=1)
    else:
        alpha = nbr_mask[..., None].expand(Nd, K, G).float()
    msg = (v + e.reshape(Nd, K, G, C)).float() * alpha[..., None]
    return torch.sum(msg, dim=1).reshape(Nd, G * C) + Sk.float()


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
