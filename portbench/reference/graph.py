"""The forward's sample of B independent lanes, built again from the state's
COO lists: each lane's node ids offset by lane (b * NG grains, b * NJ
joints), and for each edge type a destination-major table whose slots
hold a destination's live edges by ascending COO column.

State (a dict of tensors, a leading lane axis on each): xg [B, NG, 11],
xj [B, NJ, 8], E_pq [B, 2, EQ] (joint, grain), E_pp [B, 2, EP] (directed
joint pairs), -1 for a dead column. Push runs grain -> joint over E_pq,
pull joint -> grain over E_pq, connect joint -> joint over E_pp.
"""

from __future__ import annotations

import torch


def wrap(rel):
    """Minimum-image displacement on the unit torus."""
    return rel - (rel > 0.5).to(rel.dtype) + (rel < -0.5).to(rel.dtype)


def table(src, dst, n_src: int, n_dst: int, pos_src, pos_dst):
    """Destination-major table of the COO lists src -> dst [B, E] (lane-local
    ids, -1 dead) over flat node tables of B * n_src and B * n_dst rows:
    nbr [B * n_dst, K] int64, len (periodic distance), mask, with K the
    largest live in-degree; and the live edges of each lane [B]."""
    B, E = src.shape
    dev = src.device
    live = (src >= 0) & (dst >= 0)
    lane = torch.arange(B, device=dev)[:, None]
    d = torch.where(live, dst.long() + lane * n_dst, B * n_dst).reshape(-1)
    s = torch.where(live, src.long() + lane * n_src, 0).reshape(-1)
    key = d * (B * E) + torch.arange(B * E, device=dev)
    order = torch.argsort(key)
    ds, ss = d[order], s[order]
    slot = torch.arange(B * E, device=dev) - torch.searchsorted(ds, ds)
    ok = ds < B * n_dst
    K = max(int(slot[ok].max()) + 1 if bool(ok.any()) else 1, 1)
    rel = wrap(pos_src[ss] - pos_dst[torch.where(ok, ds, 0)])
    length = torch.sqrt(torch.sum(rel * rel, dim=-1))
    flat = torch.where(ok, ds * K + slot, B * n_dst * K)
    size = B * n_dst * K + 1

    def scatter(vals, dtype):
        out = torch.zeros(size, dtype=dtype, device=dev)
        return out.index_put_((flat,), vals.to(dtype))[:-1].reshape(
            B * n_dst, K)

    return ({"nbr": scatter(ss, torch.int64),
             "len": scatter(length, torch.float32),
             "mask": scatter(ok, torch.float32)},
            live.sum(-1))


def sample(state):
    """(sample, message edges [B]): the node tables, the three edge tables
    and the classifier's jj pairs (every E_pp column, dead ones at node 0
    with length 0), and each lane's live edges over the three tables."""
    xg, xj = state["xg"], state["xj"]
    B, NG, NJ = xg.shape[0], xg.shape[1], xj.shape[1]
    gx, jx = xg.reshape(B * NG, -1), xj.reshape(B * NJ, -1)
    pg, pj = gx[:, :2], jx[:, :2]
    E_pq, E_pp = state["E_pq"], state["E_pp"]
    push, n_push = table(E_pq[:, 1], E_pq[:, 0], NG, NJ, pg, pj)
    pull, n_pull = table(E_pq[:, 0], E_pq[:, 1], NJ, NG, pj, pg)
    connect, n_conn = table(E_pp[:, 0], E_pp[:, 1], NJ, NJ, pj, pj)
    live = (E_pp[:, 0] >= 0) & (E_pp[:, 1] >= 0)
    off = torch.arange(B, device=xg.device)[:, None] * NJ
    a = (E_pp[:, 0].clamp_min(0).long() + off).reshape(-1)
    b = (E_pp[:, 1].clamp_min(0).long() + off).reshape(-1)
    rel = wrap(pj[a] - pj[b])
    jj_len = torch.sqrt(torch.sum(rel * rel, dim=-1)) * live.reshape(-1)
    return ({"grain_x": gx, "joint_x": jx, "push": push, "pull": pull,
             "connect": connect, "jj_src": a, "jj_dst": b, "jj_len": jj_len},
            n_push + n_pull + n_conn)
