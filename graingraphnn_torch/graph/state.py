"""Fixed-capacity, mask-padded graph sample (destination-major ELL adjacency).

Node arrays are padded to fixed capacities with 0/1 live masks; every
junction has exactly 3 junction and 3 grain neighbors, and each grain keeps
a fixed-capacity ring of junctions, so segment softmax and segment sum are
dense masked reductions over a static neighbor axis.

`build_sample` turns the reference-layout numpy dicts (cli.extract's
pickle) into a sample on an explicit device; `stack` puts equally padded
samples on a leading batch axis and `pack` makes such a batch one
disjoint graph, which the models run as a single sample.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import numpy as np
import torch

from . import schema

# index fields of a sample, and which node table each one points into
_INDEX_ROWS = {"push_nbr": "grain", "connect_nbr": "joint",
               "pull_nbr": "joint", "jj_src": "joint", "jj_dst": "joint"}


@dataclasses.dataclass
class GraphSample:
    """One padded heterogeneous grain graph, optionally with training
    targets. After `stack` every field has a leading batch axis; after
    `pack` the node and edge axes of the batch are concatenated and only
    the row counts keep one entry per sample."""

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

    # training targets (None on the rollout's samples)
    y_grain: Optional[torch.Tensor] = None        # [NG, 2] scaled darea, extraV
    y_joint: Optional[torch.Tensor] = None        # [NJ, 2] scaled dx, dy
    y_edge_event: Optional[torch.Tensor] = None   # [E] in {-100, 0, 1}
    y_grain_event: Optional[torch.Tensor] = None  # [NG] in {0, 1}
    y_edge: Optional[torch.Tensor] = None         # [E] scaled length change
    y_edge_mask: Optional[torch.Tensor] = None    # [E]
    # unpadded row counts, the loss's denominators under any padding
    n_grain_rows: Optional[torch.Tensor] = None   # [] float32 ([B] batched)
    n_joint_rows: Optional[torch.Tensor] = None
    n_jj_rows: Optional[torch.Tensor] = None

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "GraphSample":
        """fn applied to every tensor field (None fields stay None)."""
        return GraphSample(**{
            f.name: None if getattr(self, f.name) is None
            else fn(getattr(self, f.name)) for f in dataclasses.fields(self)})

    def to(self, device) -> "GraphSample":
        return self.map(lambda t: t.to(device))


def _pad2(a: np.ndarray, rows: int, fill=0.0) -> np.ndarray:
    a = np.asarray(a)
    out = np.full((rows,) + a.shape[1:], fill, dtype=a.dtype)
    out[: a.shape[0]] = a
    return out


def build_ell(src: np.ndarray, dst: np.ndarray, attr: np.ndarray,
              num_dst: int, max_deg: int):
    """Destination-major padded neighbor lists from a COO edge list (host):
    slots fill in edge order, padding slots hold index 0 and mask 0."""
    nbr = np.zeros((num_dst, max_deg), dtype=np.int32)
    length = np.zeros((num_dst, max_deg), dtype=np.float32)
    mask = np.zeros((num_dst, max_deg), dtype=np.float32)
    fill = np.zeros(num_dst, dtype=np.int32)
    for s, d, a in zip(src, dst, attr):
        if s < 0 or d < 0:
            continue
        k = fill[d]
        if k >= max_deg:
            raise ValueError(
                f"degree overflow: dst {d} has more than {max_deg} neighbors")
        nbr[d, k] = s
        length[d, k] = a
        mask[d, k] = 1.0
        fill[d] += 1
    return nbr, length, mask


def build_ell_device(src: torch.Tensor, dst: torch.Tensor,
                     attr: torch.Tensor, num_dst: int, max_deg: int):
    """Destination-major padded neighbor lists from a padded COO edge list
    on its device (-1 marks dead columns), the counterpart of the host
    build_ell: slots fill in ascending edge index per destination, padding
    slots hold index 0 and mask 0. As in the JAX package, edges past
    max_deg into one destination are dropped (the host build_ell raises).
    A stable sort and one scatter; no host sync."""
    dev = src.device
    E = src.shape[0]
    live = (src >= 0) & (dst >= 0)
    key = torch.where(live, dst.long(), num_dst)     # dead edges sort last
    key, order = torch.sort(key, stable=True)
    pos = torch.arange(E, device=dev)
    first = torch.ones(E, dtype=torch.bool, device=dev)
    first[1:] = key[1:] != key[:-1]
    start = torch.cummax(torch.where(first, pos, 0), 0).values
    slot = pos - start
    ok = (key < num_dst) & (slot < max_deg)
    # kept edges go to their slot, the rest to one spare slot past the end
    flat = torch.where(ok, key * max_deg + slot, num_dst * max_deg)
    size = num_dst * max_deg + 1

    def scatter(values, dtype):
        out = torch.zeros(size, dtype=dtype, device=dev)
        out.scatter_(0, flat, values.to(dtype))
        return out[:-1].reshape(num_dst, max_deg)

    nbr = scatter(torch.where(ok, src[order], 0), torch.int32)
    length = scatter(torch.where(ok, attr[order], 0), torch.float32)
    mask = scatter(ok, torch.float32)
    return nbr, length, mask


def build_sample(
    feature_dicts: Dict[str, np.ndarray],
    edge_index_dicts: Dict[tuple, np.ndarray],
    edge_weight_dicts: Dict[tuple, np.ndarray],
    mask_dicts: Dict[str, np.ndarray],
    target_dicts: Optional[Dict[str, np.ndarray]] = None,
    *,
    device,
    grain_cap: Optional[int] = None,
    joint_cap: Optional[int] = None,
    jj_edge_cap: Optional[int] = None,
    grain_ring: int = schema.DEFAULT_GRAIN_RING,
) -> GraphSample:
    """A padded `GraphSample` on `device` from reference-layout numpy dicts
    (features already carry their gradient columns). Missing targets are
    zeros, edge-event labels -100."""
    gx = np.asarray(feature_dicts["grain"], dtype=np.float32)
    jx = np.asarray(feature_dicts["joint"], dtype=np.float32)
    ng, nj = gx.shape[0], jx.shape[0]
    NG = grain_cap or ng
    NJ = joint_cap or nj
    if NG < ng or NJ < nj:
        raise ValueError("capacity smaller than live node count")

    gmask = np.asarray(mask_dicts["grain"], dtype=np.float32).reshape(-1)
    jmask = np.asarray(mask_dicts["joint"], dtype=np.float32).reshape(-1)

    push_t, pull_t, connect_t = schema.EDGE_TYPES

    def coo(et):
        e = np.asarray(edge_index_dicts[et], dtype=np.int64)
        w = np.asarray(edge_weight_dicts[et], dtype=np.float32).reshape(-1)
        live = (e[0] >= 0) & (e[1] >= 0)          # drop sentinel (-1) edges
        return e[0][live], e[1][live], w[live]

    p_src, p_dst, p_w = coo(push_t)
    c_src, c_dst, c_w = coo(connect_t)
    q_src, q_dst, q_w = coo(pull_t)

    push = build_ell(p_src, p_dst, p_w, NJ, schema.JG_DEGREE)
    connect = build_ell(c_src, c_dst, c_w, NJ, schema.JJ_DEGREE)
    pull = build_ell(q_src, q_dst, q_w, NG, grain_ring)

    E = jj_edge_cap or len(c_src)
    if E < len(c_src):
        raise ValueError("jj edge capacity too small")
    jj_mask = np.zeros(E, dtype=np.float32)
    jj_mask[: len(c_src)] = 1.0

    f32 = np.float32
    t = dict(
        y_grain=np.zeros((NG, 2), f32), y_joint=np.zeros((NJ, 2), f32),
        y_edge_event=np.full(E, float(schema.EDGE_EVENT_INVALID), f32),
        y_grain_event=np.zeros(NG, f32), y_edge=np.zeros(E, f32),
        y_edge_mask=np.zeros(E, f32))
    target_dicts = target_dicts or {}
    for key, field, rows, fill in (
            ("grain", "y_grain", NG, 0.0), ("joint", "y_joint", NJ, 0.0),
            ("grain_event", "y_grain_event", NG, 0.0),
            # labels are given on live jj edges only
            ("edge_event", "y_edge_event", E, float(schema.EDGE_EVENT_INVALID)),
            ("edge", "y_edge", E, 0.0), ("edge_mask", "y_edge_mask", E, 0.0)):
        if key in target_dicts:
            a = np.asarray(target_dicts[key], f32)
            if field not in ("y_grain", "y_joint"):
                a = a.reshape(-1)
            t[field] = _pad2(a, rows, fill=fill)

    arrays = dict(
        grain_x=_pad2(gx, NG), joint_x=_pad2(jx, NJ),
        grain_mask=_pad2(gmask, NG), joint_mask=_pad2(jmask, NJ),
        push_nbr=push[0], push_len=push[1], push_mask=push[2],
        connect_nbr=connect[0], connect_len=connect[1],
        connect_mask=connect[2],
        pull_nbr=pull[0], pull_len=pull[1], pull_mask=pull[2],
        jj_src=_pad2(c_src.astype(np.int32), E),
        jj_dst=_pad2(c_dst.astype(np.int32), E),
        jj_len=_pad2(c_w.astype(f32), E), jj_mask=jj_mask, **t,
        n_grain_rows=np.asarray(ng, f32), n_joint_rows=np.asarray(nj, f32),
        n_jj_rows=np.asarray(len(c_src), f32))
    return GraphSample(**{k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                          for k, v in arrays.items()})


def stack(samples) -> GraphSample:
    """Equally padded samples on a leading batch axis."""
    fields = [f.name for f in dataclasses.fields(GraphSample)]
    return GraphSample(**{
        k: None if getattr(samples[0], k) is None
        else torch.stack([getattr(s, k) for s in samples]) for k in fields})


def pack(batch: GraphSample) -> GraphSample:
    """A stacked batch of B equally padded samples as one disjoint graph:
    node, slot and edge axes concatenated in sample order, sample b's
    indices offset by b*NG (grain sources) or b*NJ (joint sources). Masked
    slots keep index 0 plus the offset, so they stay inside their own
    sample. The row counts keep their [B] axis (the loss's per-sample
    denominators); an output [B*NJ, C] reshapes to [B, NJ, C]."""
    B, NG = batch.grain_x.shape[:2]
    NJ = batch.joint_x.shape[1]
    rows = {"grain": NG, "joint": NJ}
    out = {}
    for f in dataclasses.fields(GraphSample):
        v = getattr(batch, f.name)
        if v is None or f.name.startswith("n_"):
            out[f.name] = v
            continue
        if f.name in _INDEX_ROWS:
            step = rows[_INDEX_ROWS[f.name]]
            off = torch.arange(B, dtype=v.dtype, device=v.device) * step
            v = v + off.reshape((B,) + (1,) * (v.dim() - 1))
        out[f.name] = v.reshape((-1,) + tuple(v.shape[2:]))
    return GraphSample(**out)


def num_samples(sample: GraphSample) -> int:
    """B of a packed batch (1 for a single sample)."""
    return sample.n_joint_rows.numel()


def round_up(n: int, multiple: int) -> int:
    return ((n + multiple - 1) // multiple) * multiple
