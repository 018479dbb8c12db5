"""Symmetry data augmentation on the periodic unit domain.

The solidification dynamics are equivariant under the torus translations
and the dihedral symmetries of the square (for cubic crystals, whose
in-plane orientation angle is stored mod pi/2):

  * translation (tx, ty): positions shift mod 1, everything else is
    invariant; the conv is not translation invariant (skip, query and value
    read absolute coordinates), so this teaches the symmetry;
  * rotation by k*90deg: positions rotate about the domain centre, vector
    features and targets (dx, dy) rotate, orientation features are
    invariant (theta_x mod pi/2 is unchanged by in-plane 90deg rotations);
  * reflection (x -> 1-x): vectors flip x, and (cos theta_x, sin theta_x)
    swap (theta_x -> pi/2 - theta_x).

Scalars (z, area, extraV, G, R, span, darea, edge lengths, labels, masks,
adjacency) are invariant throughout.
"""

from __future__ import annotations

import copy
from typing import Dict, List

import numpy as np


def _map_positions(xy: np.ndarray, k: int, refl: bool, tx: float, ty: float):
    if k % 4 == 0 and not refl and tx == 0.0 and ty == 0.0:
        # the identity: no wrap, so coordinates slightly outside [0, 1)
        # (unwrapped grain centres) stay bit for bit
        return xy.copy()
    x, y = xy[:, 0].copy(), xy[:, 1].copy()
    if refl:
        x = 1.0 - x
    for _ in range(k % 4):
        x, y = y, 1.0 - x
    x = (x + tx) % 1.0
    y = (y + ty) % 1.0
    return np.stack([x, y], axis=1)


def _map_vectors(v: np.ndarray, k: int, refl: bool):
    dx, dy = v[:, 0].copy(), v[:, 1].copy()
    if refl:
        dx = -dx
    for _ in range(k % 4):
        dx, dy = dy, -dx
    return np.stack([dx, dy], axis=1)


def transform_sample(raw: Dict, k: int = 0, refl: bool = False,
                     tx: float = 0.0, ty: float = 0.0) -> Dict:
    """One symmetry applied to a raw (unpadded) sample dict with keys
    feature_dicts / target_dicts / edge_index_dicts / edge_weight_dicts /
    mask: a rotation by k * 90deg after an optional reflection, then the
    translation (tx, ty). Returns a transformed deep copy."""
    out = copy.deepcopy(raw)
    g = out["feature_dicts"]["grain"]
    j = out["feature_dicts"]["joint"]

    g[:, :2] = _map_positions(g[:, :2], k, refl, tx, ty)
    j[:, :2] = _map_positions(j[:, :2], k, refl, tx, ty)

    if refl:
        # theta_x -> pi/2 - theta_x: (cos, sin) swap
        g[:, [5, 6]] = g[:, [6, 5]]

    # joint gradient features dx, dy (columns 6:8) are displacements
    j[:, 6:8] = _map_vectors(j[:, 6:8], k, refl)

    t = out.get("target_dicts") or {}
    if "joint" in t:
        t["joint"] = _map_vectors(np.asarray(t["joint"]), k, refl)
    return out


def augment_group(raw: Dict, rng: np.random.Generator,
                  rotations: bool = True, reflections: bool = True,
                  translate: bool = True) -> List[Dict]:
    """The 8 dihedral images of one sample (fewer without rotations or
    reflections), each with a random translation drawn from rng."""
    out = []
    for refl in ([False, True] if reflections else [False]):
        for k in (range(4) if rotations else [0]):
            tx, ty = (rng.random(2) if translate else (0.0, 0.0))
            out.append(transform_sample(raw, k=k, refl=refl, tx=float(tx),
                                        ty=float(ty)))
    return out
