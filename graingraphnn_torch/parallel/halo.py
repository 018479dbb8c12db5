"""Halo-exchange graph partitioning: periodic x-stripes and a neighbour
exchange per conv.

The grain graph is spatial: its jj and jg edges are shorter than the local
grain size. Splitting the nodes into D periodic stripes by x, each
destination node reads sources only in its own stripe and the two next to
it, so a rank needs, per conv, just its two neighbours' rows: 2/D of the
graph instead of all of it.

Host side, `build_striped` (numpy): orders the nodes stripe-major, pads
each stripe to a common capacity, maps every neighbour index into the
extended [left | local | right] table (3 * cap rows) and checks that no
edge spans more than one stripe boundary. Rank side, `make_halo_forward`:
the models' forward with `src_gather` / `node_gather` hooks that build the
extended tables by the mesh's neighbour exchange (parallel.mesh); the
convs run node_proj and edge_attn on them (Ns = 3 * cap sources, Nd = cap
destinations). Its outputs are all-gathered, so every rank holds the
whole prediction, as JAX's sharded output is one array.
`make_halo_train_step` trains on one striped graph: each stripe
differentiates its partial loss (parallel.partition.partial_loss) through
the differentiable exchange, whose backward returns the boundary rows'
cotangents to the stripes that own them; loss and gradients are summed
once over the stripes.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..graph import schema, state
from .mesh import Mesh
from .partition import partial_loss, reduce_grads


class StripeMeta:
    """Permutations and capacities of one striped layout."""

    def __init__(self, D, grain_perm, joint_perm, grain_cap, joint_cap,
                 jj_cap):
        self.D = D
        self.grain_perm = grain_perm  # new order -> old index, stripe-major
        self.joint_perm = joint_perm
        self.grain_cap = grain_cap    # rows per stripe (padded)
        self.joint_cap = joint_cap
        self.jj_cap = jj_cap
        self.stripe_sizes: Dict[str, list] = {}
        self.jj_map = np.zeros((0, 2), np.int64)

    def rows(self, kind: str) -> np.ndarray:
        """Row of each original node in the [D * cap] stripe-major table."""
        cap = self.grain_cap if kind == "grain" else self.joint_cap
        perm = self.grain_perm if kind == "grain" else self.joint_perm
        out = np.zeros(len(perm), np.int64)
        pos = 0
        for s, n in enumerate(self.stripe_sizes[kind]):
            out[perm[pos: pos + n]] = s * cap + np.arange(n)
            pos += n
        return out

    def scatter_back(self, stacked, kind: str):
        """[D * cap, ...] (or [D, cap, ...]) stripe-major output -> the
        original node order; numpy in, numpy out, a tensor in, a tensor
        out on its device."""
        cap = self.grain_cap if kind == "grain" else self.joint_cap
        return _rows_of(stacked, self.D * cap, self.rows(kind))

    def scatter_back_jj(self, stacked):
        """Per-stripe jj-edge output [D * jj_cap, ...] (or [D, jj_cap,
        ...]) -> the original live jj-edge order (the classifier's
        edge_event layout that the editor thresholds)."""
        flat = self.jj_map[:, 0] * self.jj_cap + self.jj_map[:, 1]
        return _rows_of(stacked, self.D * self.jj_cap, flat)


def _rows_of(stacked, n_rows, idx):
    if isinstance(stacked, torch.Tensor):
        flat = stacked.reshape((n_rows,) + tuple(stacked.shape[
            2 if stacked.shape[0] != n_rows else 1:]))
        return flat[torch.from_numpy(idx).to(flat.device)]
    arr = np.asarray(stacked)
    flat = arr.reshape((n_rows,) + arr.shape[2 if arr.shape[0] != n_rows
                                            else 1:])
    return flat[idx]


def _stripe_of(xcoord, D):
    return np.clip((np.asarray(xcoord) % 1.0 * D).astype(int), 0, D - 1)


def _slots(stripe, D):
    """(order, sizes, slot): the stable stripe-major order of the nodes,
    each stripe's size, and each node's slot in its stripe."""
    order = np.argsort(stripe, kind="stable")
    sizes = [int((stripe == s).sum()) for s in range(D)]
    slot = np.zeros(len(stripe), np.int64)
    starts = np.concatenate([[0], np.cumsum(sizes)[:-1]]).astype(np.int64)
    slot[order] = np.arange(len(stripe)) - np.repeat(starts, sizes)
    return order, sizes, slot


def _ranks(keys):
    """Rank of each entry among the entries with the same key, in order."""
    order = np.argsort(keys, kind="stable")
    ks = keys[order]
    first = np.r_[True, ks[1:] != ks[:-1]] if len(ks) else np.zeros(0, bool)
    start = np.maximum.accumulate(np.where(first, np.arange(len(ks)), 0))
    out = np.zeros(len(keys), np.int64)
    out[order] = np.arange(len(ks)) - start
    return out


def build_striped(
    feature_dicts: Dict[str, np.ndarray],
    edge_index_dicts: Dict[tuple, np.ndarray],
    edge_weight_dicts: Dict[tuple, np.ndarray],
    mask_dicts: Dict[str, np.ndarray],
    D: int,
    target_dicts: Dict[str, np.ndarray] | None = None,
    *,
    grain_cap: int | None = None,
    joint_cap: int | None = None,
    jj_cap: int | None = None,
    stripe_x: Dict[str, np.ndarray] | None = None,
) -> Tuple[state.GraphSample, StripeMeta]:
    """A stripe-major GraphSample (CPU tensors) with a leading stripe axis
    D, its neighbour indices in the extended [left | local | right] source
    table, and its StripeMeta. `target_dicts` (grain / joint /
    grain_event node targets, edge_event labels of the live jj edges in
    edge-list order) are striped alongside.

    `stripe_x` ({"grain": [NG], "joint": [NJ]}) overrides the coordinate
    that assigns stripes, not the features. Under patch rescaling the
    feature x lives on the scaled torus, whose interaction range is the
    40 um patch's (~0.14) whatever the domain, which caps D at ~4;
    striping by the physical coordinate ((scaled + offset) / factor)
    shortens the edges by the domain factor, so D grows with the domain.
    Raises ValueError where a capacity is smaller than its largest stripe
    or an edge spans non-adjacent stripes (too many stripes)."""
    gx = np.asarray(feature_dicts["grain"], np.float32)
    jx = np.asarray(feature_dicts["joint"], np.float32)
    gmask = np.asarray(mask_dicts["grain"], np.float32).reshape(-1)
    jmask = np.asarray(mask_dicts["joint"], np.float32).reshape(-1)

    sx = stripe_x or {}
    g_stripe = _stripe_of(np.asarray(sx.get("grain", gx[:, 0])), D)
    j_stripe = _stripe_of(np.asarray(sx.get("joint", jx[:, 0])), D)
    g_order, g_sizes, g_slot = _slots(g_stripe, D)
    j_order, j_sizes, j_slot = _slots(j_stripe, D)
    g_cap = grain_cap or state.round_up(max(g_sizes), 8)
    j_cap = joint_cap or state.round_up(max(j_sizes), 8)
    if g_cap < max(g_sizes) or j_cap < max(j_sizes):
        raise ValueError("stripe capacity smaller than the largest stripe")
    kinds = {"grain": (g_stripe, g_slot, g_cap),
             "joint": (j_stripe, j_slot, j_cap)}

    def ext_index(src_old, src_type, dst_stripe):
        """Rows of source nodes in their destination stripes' extended
        tables [left | local | right] (3 * cap rows)."""
        stripe_of, slot_of, cap = kinds[src_type]
        stripe, slot = stripe_of[src_old], slot_of[src_old]
        rel = (stripe - dst_stripe) % D
        bad = (rel != 0) & (rel != D - 1) & (rel != 1)
        if bad.any():
            i = int(np.argmax(bad))
            raise ValueError(
                f"edge spans non-adjacent stripes ({stripe[i]} -> "
                f"{dst_stripe[i]}); use fewer stripes (stripe width must "
                "exceed the interaction range)")
        return np.where(rel == 0, cap + slot,
                        np.where(rel == D - 1, slot, 2 * cap + slot))

    def stack_nodes(xarr, mask, order, sizes, cap):
        out = np.zeros((D, cap, xarr.shape[1]), np.float32)
        m = np.zeros((D, cap), np.float32)
        pos = 0
        for s in range(D):
            n = sizes[s]
            out[s, :n] = xarr[order[pos: pos + n]]
            m[s, :n] = mask[order[pos: pos + n]]
            pos += n
        return out, m

    gx_s, gm_s = stack_nodes(gx, gmask, g_order, g_sizes, g_cap)
    jx_s, jm_s = stack_nodes(jx, jmask, j_order, j_sizes, j_cap)

    def live_edges(et):
        e = np.asarray(edge_index_dicts[et]).astype(np.int64)
        w = np.asarray(edge_weight_dicts[et], np.float32).reshape(-1)
        live = (e[0] >= 0) & (e[1] >= 0)
        return e[0][live], e[1][live], w[live], w

    # per-stripe ELL tables, neighbour ids in the extended source tables;
    # the k-th live edge into a node (in edge-list order) takes slot k
    push_t, pull_t, connect_t = schema.EDGE_TYPES

    def ell(et, src_type, dst_type, max_deg):
        s_old, d_old, w, _ = live_edges(et)
        d_stripe_of, d_slot_of, dst_cap = kinds[dst_type]
        st, sl = d_stripe_of[d_old], d_slot_of[d_old]
        k = _ranks(st * dst_cap + sl)
        nbr = np.zeros((D, dst_cap, max_deg), np.int32)
        length = np.zeros((D, dst_cap, max_deg), np.float32)
        mask = np.zeros((D, dst_cap, max_deg), np.float32)
        nbr[st, sl, k] = ext_index(s_old, src_type, st)
        length[st, sl, k] = w
        mask[st, sl, k] = 1.0
        return nbr, length, mask

    push_nbr, push_len, push_mask = ell(push_t, "grain", "joint",
                                        schema.JG_DEGREE)
    conn_nbr, conn_len, conn_mask = ell(connect_t, "joint", "joint",
                                        schema.JJ_DEGREE)
    pull_nbr, pull_len, pull_mask = ell(pull_t, "joint", "grain",
                                        schema.DEFAULT_GRAIN_RING)

    # the jj COO split by destination stripe, endpoints in the extended
    # joint table; each live edge's label rides along
    tg = target_dicts or {}
    ev_lab = np.asarray(tg.get("edge_event", ()), np.float32).reshape(-1)
    s_old, d_old, w, w_all = live_edges(connect_t)
    n_live = len(d_old)
    lab = np.full(n_live, float(schema.EDGE_EVENT_INVALID), np.float32)
    lab[: min(n_live, len(ev_lab))] = ev_lab[:n_live]
    st = j_stripe[d_old]
    k = _ranks(st)
    jj_need = max(int((st == s).sum()) for s in range(D))
    jj_cap = jj_cap or state.round_up(jj_need, 8)
    if jj_cap < jj_need:
        raise ValueError("jj stripe capacity smaller than the largest "
                         "stripe")
    jj_src = np.zeros((D, jj_cap), np.int32)
    jj_dst = np.zeros((D, jj_cap), np.int32)
    jj_len = np.zeros((D, jj_cap), np.float32)
    jj_mask = np.zeros((D, jj_cap), np.float32)
    y_ee = np.full((D, jj_cap), float(schema.EDGE_EVENT_INVALID), np.float32)
    jj_src[st, k] = ext_index(s_old, "joint", st)
    jj_dst[st, k] = ext_index(d_old, "joint", st)
    jj_len[st, k] = w
    jj_mask[st, k] = 1.0
    y_ee[st, k] = lab

    def stripe_targets(key, order, sizes, cap, width):
        arr = np.asarray(tg.get(key, ()), np.float32)
        out = np.zeros((D, cap, width) if width > 1 else (D, cap),
                       np.float32)
        if arr.size == 0:
            return out
        arr = arr.reshape(len(order), -1) if width > 1 else arr.reshape(-1)
        pos = 0
        for s in range(D):
            n = sizes[s]
            out[s, :n] = arr[order[pos: pos + n]]
            pos += n
        return out

    t = torch.from_numpy
    sample = state.GraphSample(
        grain_x=t(gx_s), joint_x=t(jx_s), grain_mask=t(gm_s),
        joint_mask=t(jm_s),
        push_nbr=t(push_nbr), push_len=t(push_len), push_mask=t(push_mask),
        connect_nbr=t(conn_nbr), connect_len=t(conn_len),
        connect_mask=t(conn_mask),
        pull_nbr=t(pull_nbr), pull_len=t(pull_len), pull_mask=t(pull_mask),
        jj_src=t(jj_src), jj_dst=t(jj_dst), jj_len=t(jj_len),
        jj_mask=t(jj_mask),
        y_grain=t(stripe_targets("grain", g_order, g_sizes, g_cap, 2)),
        y_joint=t(stripe_targets("joint", j_order, j_sizes, j_cap, 2)),
        y_edge_event=t(y_ee),
        y_grain_event=t(stripe_targets("grain_event", g_order, g_sizes,
                                       g_cap, 1)),
        y_edge=torch.zeros((D, jj_cap)),
        y_edge_mask=torch.zeros((D, jj_cap)),
        # one copy per stripe, so every field has the stripe axis
        n_grain_rows=torch.full((D,), float(len(gx))),
        n_joint_rows=torch.full((D,), float(len(jx))),
        n_jj_rows=torch.full((D,), float((w_all > -1).sum())),
    )
    meta = StripeMeta(D, g_order, j_order, g_cap, j_cap, jj_cap)
    meta.stripe_sizes = {"grain": g_sizes, "joint": j_sizes}
    meta.jj_map = np.stack([st, k], axis=1).astype(np.int64).reshape(-1, 2)
    return sample, meta


def _hooks(mesh: Mesh, axis: Optional[str] = None):
    """(src_gather, node_gather) of a stripe: a table's [left | local |
    right] extension by the mesh's neighbour exchange along `axis`."""
    def extend(x):
        left, right = mesh.exchange(x, axis)
        return torch.cat([left, x, right], dim=0)

    return (lambda xg, xj: (extend(xg), extend(xj))), extend


def make_halo_forward(model, mesh: Mesh):
    """f(striped) -> the model's outputs over the striped layout, stripe-
    major [D * cap, ...] (jj outputs [D * jj_cap, ...]) on every rank.
    Each rank runs its own stripe, striped[rank], on mesh.device (the hand
    kernels on a card), its source tables built by two neighbour
    exchanges per table, and all-gathers the outputs."""
    src_gather, node_gather = _hooks(mesh)

    def f(striped: state.GraphSample) -> Dict[str, torch.Tensor]:
        local = striped.map(lambda a: a[mesh.rank].to(mesh.device))
        with torch.inference_mode():
            y = model(local, kernels=True, src_gather=src_gather,
                      node_gather=node_gather)
            return {k: mesh.all_gather(v).reshape((-1,) + tuple(v.shape[1:]))
                    for k, v in y.items()}

    return f


def make_halo_train_step(hp, model, opt, sched, mesh: Mesh,
                         axis: Optional[str] = None):
    """step(striped) -> the loss of one striped graph (build_striped's
    layout with targets, one stripe a rank along `axis`): each rank runs
    striped[index] on the torch formulation with [left | local | right]
    tables from the differentiable exchange, differentiates its partial
    loss, sums the loss and the gradients over the stripes once, and
    steps the optimizer and the schedule."""
    src_gather, node_gather = _hooks(mesh, axis)

    def step(striped: state.GraphSample) -> torch.Tensor:
        local = striped.map(lambda a: a[mesh.index(axis)].to(mesh.device))
        opt.zero_grad(set_to_none=True)
        lval = partial_loss(hp, model, local, mesh, axis, src_gather,
                            node_gather)
        lval.backward()
        reduce_grads(model, mesh, axis)
        opt.step()
        sched.step()
        return mesh.all_reduce(lval.detach(), axis=axis)

    return step


def make_halo_span_forward(regressor, classifier, mesh: Mesh):
    """The rollout span's forward over halo stripes:
    f(features, edge_index, edge_weight, mask, D, caps=None, stripe_x=None)
    -> pred dict in the rollout's layout (original node and live jj-edge
    order) on mesh.device, both models' forwards split over the ranks.
    Stripes are built from the given positions on every rank alike; `caps`
    (grain_cap / joint_cap / jj_cap) pins the stripe capacities across
    spans."""
    fwd_r = make_halo_forward(regressor, mesh)
    fwd_c = make_halo_forward(classifier, mesh)

    def span_forward(features, edge_index, edge_weight, mask, D, caps=None,
                     stripe_x=None):
        if D != mesh.D:
            raise ValueError(f"{D} stripes on a mesh of {mesh.D} ranks")
        striped, meta = build_striped(features, edge_index, edge_weight,
                                      mask, D, stripe_x=stripe_x,
                                      **(caps or {}))
        y_r = fwd_r(striped)
        y_c = fwd_c(striped)
        pred = {
            "joint": meta.scatter_back(y_r["joint"], "joint"),
            "grain": meta.scatter_back(y_r["grain"], "grain"),
            "grain_area": meta.scatter_back(y_r["grain_area"],
                                            "grain").reshape(-1),
            "edge_event": meta.scatter_back_jj(y_c["edge_event"]).reshape(-1),
            "edge": meta.scatter_back_jj(y_c["edge"]),
        }
        return pred

    return span_forward
