"""The GrainGNN regressor and classifier forwards in plain PyTorch, from the
parameter trees of weights.py and a sample of graph.py.

Each model runs one fused-gate recurrent cell (HeteroPGCLSTM: the gates i,
f, c~, o of an LSTM, each the sum of one periodic graph-transformer conv
per incoming edge type) over the input from the zero state (encoder), the
same cell's twin warm-started from the encoder's state (decoder), then its
heads. The conv (PeriodConv) of a destination row i over its live
neighbours j:

    x_j' = [wrap(x_j[:3] - x_i[:3]), x_j[3:]]        (periodic relocation)
    k_ij = x_j' Wk + bk + len_ij we,  v_ij = l2(relu(x_j' Wv + bv)) + len_ij we
    out_i = sum_j softmax_j(<q_i, k_ij> / sqrt(C)) v_ij + x_i Ws + bs,
    q_i = x_i Wq + bq

per gate, l2 block-diagonal across the gates. The product x_j' Wk is split
into x_j[3:] Wk[3:] (per node) and the relocated position times Wk[:3]
(per edge). `r` rounds the operands where the configuration states it:
identity in fp32; in bf16 (the TPU conv kernel at its bf16 operands) the
features, weights, relocated positions, each logit product, relu(v) and
alpha, with float32 sums and float32 biases. The rest of the model (LSTM
update, heads) is float32 in every configuration.
"""

from __future__ import annotations

import math

import torch

POS = 3          # (x, y, z) lead the feature columns
NEG = -1e30
BLOCK = 8192     # destination rows of a conv's edge stage at a time


def _wrap_shift(rel):
    return -(rel > 0.5).to(rel.dtype) + (rel < -0.5).to(rel.dtype)


def _masked_softmax(logits, mask):
    """Softmax over the slot axis (1) where mask > 0; rows without a live
    slot give zeros."""
    valid = mask > 0
    masked = torch.where(valid, logits, torch.full_like(logits, NEG))
    m = torch.amax(masked, dim=1, keepdim=True)
    m = torch.where(m <= NEG / 2, torch.zeros_like(m), m)
    e = torch.where(valid, torch.exp(masked - m), torch.zeros_like(logits))
    return e / torch.clamp_min(torch.sum(e, dim=1, keepdim=True), 1e-30)


def conv(p, x_src, x_dst, table, G: int, C: int, r):
    """One fused-gate PeriodConv: [Nd, G * C]. table: nbr [Nd, K] int64 rows
    of x_src, len [Nd, K], mask [Nd, K]."""
    Wk, Wv = p["key"]["w"], p["value"]["w"]
    xs, xd = r(x_src[:, POS:]), r(x_dst)
    Kn = xs @ r(Wk[POS:]) + p["key"]["b"]
    Vn = xs @ r(Wv[POS:]) + p["value"]["b"]
    Q = xd @ r(p["query"]["w"]) + p["query"]["b"]
    Sk = xd @ r(p["skip"]["w"]) + p["skip"]["b"]
    wk_pos, wv_pos = r(Wk[:POS]), r(Wv[:POS])
    l2w, l2b, we = r(p["l2"]["w"]), p["l2"]["b"], p["edge"]["w"]
    pos_src = r(x_src[:, :POS])
    nbr, length, mask = table["nbr"], table["len"], table["mask"]
    Nd, K = nbr.shape
    out = torch.empty((Nd, G * C), dtype=torch.float32, device=x_dst.device)
    for a in range(0, Nd, BLOCK):
        b = min(a + BLOCK, Nd)
        n = b - a
        nb = nbr[a:b]
        rel = pos_src[nb] - r(x_dst[a:b, None, :POS])            # [n, K, 3]
        xjp = r(rel + _wrap_shift(rel))
        e = length[a:b, :, None] * we                            # [n, K, GC]
        k_e = Kn[nb] + xjp @ wk_pos + e
        pre_v = Vn[nb] + xjp @ wv_pos
        logits = torch.sum(r(Q[a:b].reshape(n, 1, G, C)
                             * k_e.reshape(n, K, G, C)), dim=-1) * (
                                 1.0 / math.sqrt(C))             # [n, K, G]
        alpha = r(_masked_softmax(logits, mask[a:b, :, None]))
        v = torch.einsum("nkgc,gcd->nkgd",
                         r(torch.relu(pre_v)).reshape(n, K, G, C), l2w) + l2b
        msg = (v + e.reshape(n, K, G, C)) * alpha[..., None]
        out[a:b] = torch.sum(msg, dim=1).reshape(n, G * C) + Sk[a:b]
    return out


def _lstm(gates, c, C):
    i = torch.sigmoid(gates[:, 0 * C:1 * C])
    f = torch.sigmoid(gates[:, 1 * C:2 * C])
    g = torch.tanh(gates[:, 2 * C:3 * C])
    o = torch.sigmoid(gates[:, 3 * C:4 * C])
    c = f * c + i * g
    return o * torch.tanh(c), c


def cell(p, sample, state, C: int, r):
    """One HeteroPGCLSTM step: state = (h_grain, h_joint, c_grain,
    c_joint), returned updated."""
    hg, hj, cg, cj = state
    G = p["bias"]["grain"].shape[0]
    xg = torch.cat([sample["grain_x"], hg], dim=1)
    xj = torch.cat([sample["joint_x"], hj], dim=1)
    to_joint = (conv(p["conv"]["push"], xg, xj, sample["push"], G, C, r)
                + conv(p["conv"]["connect"], xj, xj, sample["connect"], G, C,
                       r)
                + p["bias"]["joint"].reshape(-1))
    to_grain = (conv(p["conv"]["pull"], xj, xg, sample["pull"], G, C, r)
                + p["bias"]["grain"].reshape(-1))
    hg, cg = _lstm(to_grain, cg, C)
    hj, cj = _lstm(to_joint, cj, C)
    return hg, hj, cg, cj


def _encode_decode(params, sample, C, r):
    if len(params["encoder"]) != 1 or len(params["decoder"]) != 1:
        raise ValueError("the reference runs one-layer stacks")
    zg = sample["grain_x"].new_zeros((sample["grain_x"].shape[0], C))
    zj = sample["joint_x"].new_zeros((sample["joint_x"].shape[0], C))
    enc = cell(params["encoder"][0], sample, (zg, zj, zg, zj), C, r)
    hg, hj, _, _ = cell(params["decoder"][0], sample, enc, C, r)
    return hg, hj


def regressor(params, sample, C: int, r):
    """joint [NJ, 2] (tanh dx, dy), grain [NG, 2] (tanh darea, relu
    extraV), grain_area [NG] (darea / 20 plus the grain's area)."""
    hg, hj = _encode_decode(params, sample, C, r)
    head = params["head"]
    joint = torch.tanh(hj @ head["joint"]["w"] + head["joint"]["b"])
    raw = hg @ head["grain"]["w"] + head["grain"]["b"]
    darea, extrav = torch.tanh(raw[:, 0]), torch.relu(raw[:, 1])
    return {"joint": joint, "grain": torch.stack([darea, extrav], dim=1),
            "grain_area": darea / 20.0 + sample["grain_x"][:, 3]}


def classifier(params, sample, C: int, r):
    """The switch logit of each directed jj column [E]."""
    _, hj = _encode_decode(params, sample, C, r)
    pair = torch.cat([hj[sample["jj_src"]], hj[sample["jj_dst"]],
                      sample["jj_len"][:, None]], dim=1)
    return (pair @ params["lin2"]["w"] + params["lin2"]["b"])[:, 0]
