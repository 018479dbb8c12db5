"""Planar polygonal cross-section graph (host-side bookkeeping, numpy).

The 2D microstructure at one height is a planar graph: triple-junction
vertices, grain regions and junction-junction edges on a periodic (or
no-flux) unit domain. `PlanarGraph` rebuilds the grain polygons from the
junction->grains incidence, rasterises them to a grain-id image and
measures the pixel-mismatch layer error.

The raster paints each polygon with a scanline fill (`paint_polygons`)
that reproduces the pixels of Pillow's `ImageDraw.polygon` fill, in
numpy: frame-0 grain areas are pixel counts of this raster and feed the
models' area feature, so the fill must agree with the raster the JAX
package paints with Pillow pixel for pixel.
"""

from __future__ import annotations

import math
from collections import defaultdict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

EPS = 1e-12

_F32 = np.float32
_HALF = np.float32(0.5)
_ONE = np.float32(1.0)


def periodic_move_pt(p, pc):
    """Return p shifted by whole periods into pc's image."""
    x, y = p
    xc, yc = pc
    x += -1 * ((x - xc) > 0.5) + 1 * ((x - xc) < -0.5)
    y += -1 * ((y - yc) > 0.5) + 1 * ((y - yc) < -0.5)
    return [x, y]


def periodic_dist_pt(p, pc) -> float:
    x, y = p
    xc, yc = pc
    if x < xc - 0.5 - EPS: x += 1
    if x > xc + 0.5 + EPS: x -= 1
    if y < yc - 0.5 - EPS: y += 1
    if y > yc + 0.5 + EPS: y -= 1
    return math.sqrt((x - xc) ** 2 + (y - yc) ** 2)


def ccw_key(point, center):
    """Sort key (angle, radius) for counterclockwise polygon ordering."""
    vx, vy = point[0] - center[0], point[1] - center[1]
    r = math.hypot(vx, vy)
    if r == 0:
        return -math.pi, 0.0
    ang = math.atan2(vy, vx)
    if ang < 0:
        ang += 2 * math.pi
    return ang, r


def shares_two_grains(j1, j2) -> bool:
    """Two junctions are linked by a grain-boundary edge iff they share
    exactly two grain labels."""
    return len(set(j1) & set(j2)) == 2


# ----------------------------------------------------------------------
# scanline polygon fill
# ----------------------------------------------------------------------
def _roundf(v):
    """C roundf (half away from zero) of float32 values, as float32."""
    v = v.astype(np.float64)
    return np.where(v >= 0, np.floor(v + 0.5), -np.floor(-v + 0.5)).astype(_F32)


def _round_up(v):
    """First pixel of a span whose left crossing is v (float32)."""
    a = np.abs(v) + _HALF
    return np.where(v >= 0, np.floor(v + _HALF), -np.floor(a)).astype(np.int64)


def _round_down(v):
    """Last pixel of a span whose right crossing is v (float32)."""
    a = np.abs(v) - _HALF
    return np.where(v >= 0, np.ceil(v - _HALF), -np.ceil(a)).astype(np.int64)


def _x_at(y, x0, y0, dx):
    """An edge's crossing at row y, in float32 as the fill computes it."""
    return (y - y0).astype(_F32) * dx + x0.astype(_F32)


def paint_polygons(height: int, width: int,
                   rings: Sequence[np.ndarray]) -> np.ndarray:
    """Fill integer polygons in order onto a [height, width] canvas.

    rings: [n_i, 2] integer (x, y) vertex lists, closed implicitly. Returns
    an int32 canvas holding, per pixel, the index of the last ring that
    painted it (-1 where none did): later rings overwrite earlier ones.

    The fill is Pillow's (`ImageDraw.polygon` with a fill and no
    outline), vectorised over all rings:
    - edges join consecutive vertices; the closing edge is dropped when
      the last vertex equals the first;
    - horizontal edges paint their whole run;
    - each row from the ring's top to its bottom (clipped to the canvas,
      the bottom to `height`) takes each other edge's crossing there in
      float32, twice where the edge ends on that row above the ring's
      last row;
    - where sloped edges both start on a row, or both end on the ring's
      last row, at crossings that round to the same pixel, the first
      earlier such edge decides for a later one: if their slopes have
      one sign, the later crossing moves to one pixel beyond the two
      edges' crossings on the adjacent row, when it lies more than a
      pixel past both;
    - sorted crossings pair up into spans from round-half-up of the left
      to round-half-down of the right; an empty span paints nothing.
    It was held pixel-equal to Pillow 12.1 on random integer rings,
    self-intersecting and coincident vertices included."""
    canvas = np.full(height * width, -1, np.int32)
    rings = [np.asarray(r, np.int64).reshape(-1, 2) for r in rings]
    n = np.array([len(r) for r in rings], np.int64)
    if len(rings) == 0 or n.sum() == 0:
        return canvas.reshape(height, width)
    pts = np.concatenate(rings)
    poly = np.repeat(np.arange(len(rings)), n)
    first = np.cumsum(n) - n
    local = np.arange(len(pts)) - first[poly]
    last = local == n[poly] - 1
    nxt = np.where(last, first[poly], np.arange(len(pts)) + 1)
    keep = ~(last & np.all(pts == pts[nxt], axis=1))
    ex0, ey0 = pts[keep, 0], pts[keep, 1]
    ex1, ey1 = pts[nxt[keep], 0], pts[nxt[keep], 1]
    ep = poly[keep]
    eymin, eymax = np.minimum(ey0, ey1), np.maximum(ey0, ey1)

    # each ring's rows: the C fill starts from (height - 1, 0) and clips
    P = len(rings)
    ymin_p = np.full(P, height - 1, np.int64)
    ymax_p = np.zeros(P, np.int64)
    np.minimum.at(ymin_p, ep, eymin)
    np.maximum.at(ymax_p, ep, eymax)
    ymin_p = np.maximum(ymin_p, 0)
    ymax_p = np.minimum(ymax_p, height)

    spans = []    # (ring, y, x_first, x_last)
    horiz = ey0 == ey1
    spans.append((ep[horiz], ey0[horiz], np.minimum(ex0, ex1)[horiz],
                  np.maximum(ex0, ex1)[horiz]))

    # sloped edges in ring order: their crossings on every row they span
    sl = ~horiz
    x0, y0, p = ex0[sl], ey0[sl], ep[sl]
    lo, hi = eymin[sl], eymax[sl]
    dx = (ex1[sl] - x0).astype(_F32) / (ey1[sl] - y0).astype(_F32)
    e_id = np.arange(len(x0))
    r0 = np.maximum(lo, ymin_p[p])
    r1 = np.minimum(hi, ymax_p[p])
    cnt = np.maximum(r1 - r0 + 1, 0)
    row_e = np.repeat(e_id, cnt)
    y = np.repeat(r0 - (np.cumsum(cnt) - cnt), cnt) + np.arange(cnt.sum())
    xs = _x_at(y, x0[row_e], y0[row_e], dx[row_e])
    at_end = y == hi[row_e]
    dup = at_end & (y < ymax_p[p[row_e]])

    # joined corners: candidates are crossings at an edge's end row (its
    # start, or its end on the ring's last row) with a nonzero slope; the
    # first earlier candidate of the ring that ends there the same way at
    # a crossing rounding to the same pixel decides, and only one whose
    # slope has the same sign moves the crossing
    cand = np.nonzero(~dup & (dx[row_e] != 0)
                      & ((y == lo[row_e]) | at_end))[0]
    if len(cand):
        ce = row_e[cand]
        kind = at_end[cand].astype(np.int64)
        order = np.lexsort((ce, kind, y[cand], p[ce]))
        cand, ce, kind = cand[order], ce[order], kind[order]
        key = np.stack([p[ce], y[cand], kind])
        grp_start = np.ones(len(cand), bool)
        grp_start[1:] = np.any(key[:, 1:] != key[:, :-1], axis=0)
        gidx = np.cumsum(grp_start) - 1
        pos = np.arange(len(cand)) - np.nonzero(grp_start)[0][gidx]
        rx = _roundf(xs[cand])
        partner = np.full(len(cand), -1, np.int64)
        for lag in range(1, int(pos.max()) + 1):
            q = np.arange(len(cand)) - lag
            ok = pos >= lag
            qs = np.where(ok, q, 0)
            hit = ok & (rx[qs] == rx)
            partner = np.where(hit, qs, partner)
        has = partner >= 0
        has[has] = (dx[ce[has]] > 0) == (dx[ce[partner[has]]] > 0)
        c, q = cand[has], partner[has]
        cur, oth = ce[has], ce[q]
        yy = y[c] + np.where(kind[has] == 1, -1, 1)
        adj = _x_at(yy, x0[cur], y0[cur], dx[cur])
        adjo = _x_at(yy, x0[oth], y0[oth], dx[oth])
        xc = xs[c]
        right = (xc > adj + _ONE) & (xc > adjo + _ONE)
        left = ~right & (xc < adj - _ONE) & (xc < adjo - _ONE)
        moved = np.where(right, _roundf(np.maximum(adj, adjo)) + _ONE,
                         np.where(left, _roundf(np.minimum(adj, adjo)) - _ONE,
                                  xc))
        xs = xs.copy()
        xs[c] = moved

    # crossings per (ring, row), sorted and paired into spans
    cp = np.concatenate([p[row_e], p[row_e][dup]])
    cy = np.concatenate([y, y[dup]])
    cx = np.concatenate([xs, xs[dup]])
    order = np.lexsort((cx, cy, cp))
    cp, cy, cx = cp[order], cy[order], cx[order]
    if len(cp):
        start = np.ones(len(cp), bool)
        start[1:] = (cp[1:] != cp[:-1]) | (cy[1:] != cy[:-1])
        gidx = np.cumsum(start) - 1
        rank = np.arange(len(cp)) - np.nonzero(start)[0][gidx]
        left = np.nonzero(rank % 2 == 0)[0]
        left = left[(left + 1 < len(cp))]
        left = left[gidx[left + 1] == gidx[left]]
        a, b = _round_up(cx[left]), _round_down(cx[left + 1])
        ok = b >= a
        spans.append((cp[left][ok], cy[left][ok], a[ok], b[ok]))

    sp = np.concatenate([s[0] for s in spans])
    sy = np.concatenate([s[1] for s in spans])
    sa = np.concatenate([s[2] for s in spans])
    sb = np.concatenate([s[3] for s in spans])
    ok = (sy >= 0) & (sy < height) & (sa < width) & (sb >= 0)
    sp, sy = sp[ok], sy[ok]
    sa, sb = np.maximum(sa[ok], 0), np.minimum(sb[ok], width - 1)
    length = sb - sa + 1
    base = sy * width + sa - (np.cumsum(length) - length)
    pix = np.repeat(base, length) + np.arange(length.sum())
    np.maximum.at(canvas, pix, np.repeat(sp, length).astype(np.int32))
    return canvas.reshape(height, width)


class PlanarGraph:
    """Junction/region bookkeeping for one cross-section.

      vertices: {vertex_id: (x, y)}
      joint2vertex: {sorted grain-triple: vertex_id}
      vertex2joint: inverse
      edges: list of [src, dst] vertex pairs (directed, both ways; [-1,-1]
             marks deleted slots)
      regions / region_coors / region_center: per-grain sorted vertex rings
    """

    def __init__(self, bc: str = "periodic",
                 imagesize: Tuple[int, int] = (501, 501)):
        self.BC = bc
        self.imagesize = imagesize
        self.vertices: Dict[int, list] = {}
        self.joint2vertex: Dict[tuple, int] = {}
        self.vertex2joint: Dict[int, tuple] = {}
        self.edges: List[List[int]] = []
        self.quadruples: Dict[int, tuple] = {}
        self.corner_grains = [0, 0, 0, 0]
        self.regions: Dict[int, List[int]] = {}
        self.region_coors: Dict[int, List[list]] = {}
        self.region_center: Dict[int, list] = {}
        self.vertex_neighbor: Dict[int, set] = {}
        self.alpha_field = np.zeros((imagesize[1], imagesize[0]), dtype=int)
        self.error_layer = 0.0
        self.raise_err = True
        self.max_y = 1.0

    def rebuild_regions(self, init_edges: bool = False,
                        verbose: bool = False):
        """Grain rings from the junction->grains incidence: each grain's
        junctions unwrapped into one periodic image, shifted into the
        positive quadrant and sorted counterclockwise about their mean;
        with init_edges, the ring edges (quadruple twins swapped where a
        ring's edge would not share two grains)."""
        self.vertex_neighbor = {}
        self.regions = {}
        self.region_coors = {}
        self.region_center = {}
        region_bound = {}

        grouping: Dict[int, List[int]] = defaultdict(list)
        for joint, v in self.joint2vertex.items():
            for g in set(joint):
                grouping[g].append(v)

        for region, vert_ids in grouping.items():
            coors = [list(self.vertices[v]) for v in vert_ids]
            if len(coors) <= 1:
                continue
            if self.BC == "periodic":
                for i in range(1, len(coors)):
                    coors[i] = periodic_move_pt(coors[i], coors[i - 1])
            if self.BC == "noflux" and region > 1:
                arr = np.array(coors)
                region_bound[region] = [arr[:, 0].min(), arr[:, 0].max(),
                                        arr[:, 1].min(), arr[:, 1].max()]

            inbound = [all(c[0] > -EPS for c in coors),
                       all(c[1] > -EPS for c in coors)]
            moved = [[c[0] + (0 if inbound[0] else 1),
                      c[1] + (0 if inbound[1] else 1)] for c in coors]

            cx = float(np.mean([c[0] for c in moved]))
            cy = float(np.mean([c[1] for c in moved]))
            self.region_center[region] = [cx, cy]

            order = sorted(range(len(moved)),
                           key=lambda i: ccw_key(moved[i], (cx, cy)))
            if self.BC == "noflux" and region == 1:
                order.reverse()
            self.region_coors[region] = [moved[i] for i in order]
            self.regions[region] = [vert_ids[i] for i in order]

            if init_edges:
                ring = self.regions[region]
                grain_edge = [[ring[i], ring[(i + 1) % len(ring)]]
                              for i in range(len(ring))]
                keep = True
                if region in self.quadruples:
                    qa, qb = self.quadruples[region]
                    for a, b in grain_edge:
                        if a in (qa, qb) or b in (qa, qb):
                            if not shares_two_grains(self.vertex2joint[a],
                                                     self.vertex2joint[b]):
                                keep = False
                if not keep:
                    qa, qb = self.quadruples[region]
                    swap = {qa: qb, qb: qa}
                    grain_edge = [[swap.get(a, a), swap.get(b, b)]
                                  for a, b in grain_edge]
                self.edges.extend(grain_edge)

        for src, dst in self.edges:
            if src > -1:
                self.vertex_neighbor.setdefault(src, set()).add(dst)
        if verbose:
            bad = {v: n for v, n in self.vertex_neighbor.items()
                   if len(n) != 3}
            if bad:
                print("junctions with degree != 3:", bad)

        if self.BC == "noflux" and region_bound:
            keys = np.array(list(region_bound.keys()))
            gb = np.array(list(region_bound.values()))
            my = self.max_y
            self.corner_grains[0] = int(keys[(np.abs(gb[:, 0]) < 1e-6)
                                             & (np.abs(gb[:, 2]) < 1e-6)][0])
            self.corner_grains[1] = int(keys[(np.abs(1 - gb[:, 1]) < 1e-6)
                                             & (np.abs(gb[:, 2]) < 1e-6)][0])
            self.corner_grains[2] = int(keys[(np.abs(gb[:, 0]) < 1e-6)
                                             & (np.abs(my - gb[:, 3]) < 1e-6)][0])
            self.corner_grains[3] = int(keys[(np.abs(1 - gb[:, 1]) < 1e-6)
                                             & (np.abs(my - gb[:, 3]) < 1e-6)][0])

    def rasterize(self, imagesize: Optional[Tuple[int, int]] = None
                  ) -> np.ndarray:
        """Paint each grain polygon with its id and return the grain-id
        field. Periodic domains paint on a doubled canvas (vertices
        truncated to pixels) and take the max over the four unit-cell
        tiles; no-flux domains round the vertices, skip the boundary grain
        1 and give unpainted pixels the id of their quadrant's corner
        grain."""
        if not imagesize or imagesize == (0, 0):
            imagesize = self.imagesize
        s = imagesize[0]
        noflux = self.BC != "periodic"
        if noflux:
            width, height = imagesize[0], imagesize[1]
        else:
            width = height = 2 * s
        ids, rings = [], []
        for region_id, poly in self.region_coors.items():
            if noflux and region_id == 1:
                continue
            scaled = np.array(poly, dtype=np.float64) * s
            pts = np.round(scaled) if noflux else scaled
            if len(poly) > 1:
                ids.append(region_id)
                rings.append(pts.astype(int))
        painted = paint_polygons(height, width, rings)
        img = np.where(painted >= 0,
                       np.asarray(ids, dtype=int)[np.maximum(painted, 0)]
                       if ids else 0, 0)

        if not noflux:
            tiles = np.stack([img[:s, :s], img[s:, :s], img[:s, s:],
                              img[s:, s:]])
            self.alpha_field = np.max(tiles, axis=0)
        else:
            xv, yv = np.meshgrid(np.arange(imagesize[0]),
                                 np.arange(imagesize[1]))
            patch = 2 * xv // imagesize[0] + 2 * (2 * yv // imagesize[1])
            self.alpha_field = img + np.array(self.corner_grains)[patch] * (
                img == 0)

        if self.raise_err:
            assert np.all(self.alpha_field > 0), "unassigned pixels in raster"
        return self.alpha_field

    def layer_error(self, alpha_pde: np.ndarray) -> float:
        """Pixel misclassification fraction against a reference field."""
        self.error_layer = float(
            np.sum(alpha_pde != self.alpha_field) / alpha_pde.size)
        return self.error_layer

    def sync_maps(self):
        self.vertex2joint = {v: k for k, v in self.joint2vertex.items()}
