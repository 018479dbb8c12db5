"""Synthetic heterographs with real spatial structure (numpy only).

Nodes are laid out on the periodic unit square with short-ranged edges, and
every joint keeps the exactly-3 jj / 3 jg degree invariant. They stand in
for extracted phase-field windows where none are at hand: the training
phase of chip_smoke.py trains on `spatial_ring_arrays` graphs.
"""

from __future__ import annotations

import numpy as np

from . import schema


def brick_wall_arrays(ng: int, seed: int = 0):
    """Exactly-symmetric periodic brick-wall microstructure: the true
    T-junction adjacency of offset rectangular grains, so every jj edge
    exists in BOTH directions (the directed-pair convention of extracted
    graphs) and every joint is exactly trivalent.

    spatial_ring_arrays approximates adjacency by 3-nearest-neighbor
    queries, which leaves ~30% of jj edges unpaired — fine for forwards
    and single-span editor tests, but a topology EDIT on an unpaired edge
    breaks the degree-3 invariant (the editor rewires assuming the
    reverse edge exists). Multi-span rollout legs use this constructor.

    Grain (i, j): rectangle [i+s(j), i+1+s(j)]/gx x [j, j+1]/gy with
    s(j) = 0.5*(j%2). Joints per grain g: v0 = 2g (bottom-left corner),
    v1 = 2g+1 (bottom-middle T-point). gy must be even for periodic row
    parity; grain rings have 6 joints.
    """
    rng = np.random.default_rng(seed)
    gx = int(round(np.sqrt(ng)))
    while ng % gx:
        gx -= 1
    gy = ng // gx
    if gy % 2:
        raise ValueError(f"gy={gy} must be even for periodic row parity "
                         f"(pick ng with an even factor split)")
    nj = 2 * ng

    def gid(i, j):
        return (i % gx) + gx * (j % gy)

    def v0(i, j):
        return 2 * gid(i, j)

    def v1(i, j):
        return 2 * gid(i, j) + 1

    def shift(j):
        return 0.5 * ((j % gy) % 2)

    grain_pos = np.zeros((ng, 2), np.float32)
    joint_pos = np.zeros((nj, 2), np.float32)
    for j in range(gy):
        for i in range(gx):
            g = gid(i, j)
            x0 = (i + shift(j)) / gx
            y0 = j / gy
            grain_pos[g] = ((x0 + 0.5 / gx) % 1.0, y0 + 0.5 / gy)
            joint_pos[2 * g] = (x0 % 1.0, y0)
            joint_pos[2 * g + 1] = ((x0 + 0.5 / gx) % 1.0, y0)

    jj_pairs = []   # undirected, stored both ways below
    jg_src, jg_dst = [], []
    for j in range(gy):
        even = (j % 2) == 0
        for i in range(gx):
            a = v0(i, j)
            b = v1(i, j)
            # horizontal wall neighbors on line y_j
            jj_pairs.append((a, b))                       # v0 -- v1 (right)
            jj_pairs.append((b, v0(i + 1, j)))            # v1 -- next v0
            # vertical wall above v0 ends at a row-(j+1) T-point
            up = v1(i - 1, j + 1) if even else v1(i, j + 1)
            jj_pairs.append((a, up))
            # grains bordering v0: left/right of its vertical wall + below
            below_v0 = gid(i - 1, j - 1) if even else gid(i, j - 1)
            for g in (gid(i - 1, j), gid(i, j), below_v0):
                jg_src.append(g)
                jg_dst.append(a)
            # grains bordering v1: above + the two below its row-(j-1) wall
            lo = (gid(i - 1, j - 1), gid(i, j - 1)) if even else \
                 (gid(i, j - 1), gid(i + 1, j - 1))
            for g in (gid(i, j),) + lo:
                jg_src.append(g)
                jg_dst.append(b)

    jj_srca = np.asarray([p[0] for p in jj_pairs]
                         + [p[1] for p in jj_pairs], np.int64)
    jj_dsta = np.asarray([p[1] for p in jj_pairs]
                         + [p[0] for p in jj_pairs], np.int64)
    jg_src = np.asarray(jg_src)
    jg_dst = np.asarray(jg_dst)

    def wrap(d):
        return d - np.round(d)

    def plen(psrc, pdst, src, dst):
        d = wrap(psrc[src] - pdst[dst])
        return np.sqrt((d * d).sum(1)).astype(np.float32)

    gj_len = plen(grain_pos, joint_pos, jg_src, jg_dst)
    jj_len = plen(joint_pos, joint_pos, jj_srca, jj_dsta)

    gxf = np.zeros((ng, schema.GRAIN_DIM), np.float32)
    jxf = np.zeros((nj, schema.JOINT_DIM), np.float32)
    gxf[:, :2] = grain_pos
    jxf[:, :2] = joint_pos
    gxf[:, 3:] = rng.uniform(0, 1, (ng, schema.GRAIN_DIM - 3)).astype(np.float32)
    jxf[:, 3:] = rng.uniform(0, 1, (nj, schema.JOINT_DIM - 3)).astype(np.float32)

    feats = {"grain": gxf, "joint": jxf}
    ei = {
        schema.EDGE_TYPES[0]: np.array([jg_src, jg_dst]),
        schema.EDGE_TYPES[1]: np.array([jg_dst, jg_src]),
        schema.EDGE_TYPES[2]: np.array([jj_srca, jj_dsta]),
    }
    ew = {
        schema.EDGE_TYPES[0]: gj_len[:, None],
        schema.EDGE_TYPES[1]: gj_len[:, None],
        schema.EDGE_TYPES[2]: jj_len[:, None],
    }
    masks = {
        "grain": np.ones((ng, 1), np.float32),
        "joint": np.ones((nj, 1), np.float32),
    }
    return feats, ei, ew, masks, None


def spatial_ring_arrays(ng: int, seed: int = 0):
    """Periodic 'brick wall' microstructure stand-in: ng grains on an
    aspect-ratio-balanced gx x gy grid, one grain column/row offset per row
    so every vertical wall ends at two trivalent junctions (2 joints per
    grain, exactly like a real grain boundary network). All edges connect
    spatially adjacent nodes (length ~ one cell).

    Returns (feature_dicts, edge_index_dicts, edge_weight_dicts, mask_dicts,
    target_dicts) in the layout state.build_sample consumes.
    """
    rng = np.random.default_rng(seed)
    gx = int(round(np.sqrt(ng)))
    while ng % gx:
        gx -= 1
    gy = ng // gx
    nj = 2 * ng

    def gid(i, j):
        return (i % gx) + gx * (j % gy)

    # grain (i, j) spans x in [i, i+1]/gx (shifted half a cell on odd rows),
    # y in [j, j+1]/gy. Its two joints sit on its bottom edge: the corners
    # where the row below's offset walls meet.
    def shift(j):
        return 0.5 * (j % 2)

    grain_pos = np.zeros((ng, 2), np.float32)
    joint_pos = np.zeros((nj, 2), np.float32)
    # joints 2*g and 2*g+1 belong to grain g's bottom-left / bottom-middle
    for j in range(gy):
        for i in range(gx):
            g = gid(i, j)
            x0 = (i + shift(j)) / gx
            y0 = j / gy
            grain_pos[g] = ((x0 + 0.5 / gx) % 1.0, y0 + 0.5 / gy)
            joint_pos[2 * g] = (x0 % 1.0, y0)
            joint_pos[2 * g + 1] = ((x0 + 0.5 / gx) % 1.0, y0)

    # joint 2g (bottom-left corner of grain g at (i,j)): touches grain g,
    # left neighbor gid(i-1,j), and below gid(i-1+..., j-1) depending on
    # row parity. Use nearest-center assignment to keep it simple and
    # guaranteed-local: each joint takes the 3 nearest grain centers.
    def wrap(d):
        return d - np.round(d)

    jg_src, jg_dst, jj_src, jj_dst = [], [], [], []
    for v in range(nj):
        d = wrap(grain_pos - joint_pos[v])
        near = np.argsort((d * d).sum(1))[:3]
        for g in near:
            jg_src.append(int(g))
            jg_dst.append(v)
    # jj edges: each joint to its 3 nearest other joints (trivalent network)
    for v in range(nj):
        d = wrap(joint_pos - joint_pos[v])
        near = [int(u) for u in np.argsort((d * d).sum(1)) if u != v][:3]
        for u in near:
            jj_src.append(u)
            jj_dst.append(v)

    def plen(psrc, pdst, src, dst):
        d = wrap(psrc[src] - pdst[dst])
        return np.sqrt((d * d).sum(1)).astype(np.float32)

    jg_src = np.asarray(jg_src)
    jg_dst = np.asarray(jg_dst)
    jj_srca = np.asarray(jj_src)
    jj_dsta = np.asarray(jj_dst)
    gj_len = plen(grain_pos, joint_pos, jg_src, jg_dst)
    jj_len = plen(joint_pos, joint_pos, jj_srca, jj_dsta)

    gxf = np.zeros((ng, schema.GRAIN_DIM), np.float32)
    jxf = np.zeros((nj, schema.JOINT_DIM), np.float32)
    gxf[:, :2] = grain_pos
    jxf[:, :2] = joint_pos
    gxf[:, 3:] = rng.uniform(0, 1, (ng, schema.GRAIN_DIM - 3)).astype(np.float32)
    jxf[:, 3:] = rng.uniform(0, 1, (nj, schema.JOINT_DIM - 3)).astype(np.float32)

    feats = {"grain": gxf, "joint": jxf}
    ei = {
        schema.EDGE_TYPES[0]: np.array([jg_src, jg_dst]),
        schema.EDGE_TYPES[1]: np.array([jg_dst, jg_src]),
        schema.EDGE_TYPES[2]: np.array([jj_srca, jj_dsta]),
    }
    ew = {
        schema.EDGE_TYPES[0]: gj_len[:, None],
        schema.EDGE_TYPES[1]: gj_len[:, None],
        schema.EDGE_TYPES[2]: jj_len[:, None],
    }
    masks = {
        "grain": np.ones((ng, 1), np.float32),
        "joint": np.ones((nj, 1), np.float32),
    }
    targets = {
        "grain": rng.uniform(-0.9, 0.9, (ng, 2)).astype(np.float32),
        "joint": rng.uniform(-0.9, 0.9, (nj, 2)).astype(np.float32),
        "grain_event": (rng.uniform(size=ng) < 0.1).astype(np.float32),
        "edge_event": rng.choice(
            [-100.0, 0.0, 1.0], size=len(jj_srca), p=[0.1, 0.8, 0.1]
        ).astype(np.float32),
    }
    return feats, ei, ew, masks, targets
