"""A lane's starting state worked out again from its host graph (the
generator's float64 features, COO lists and masks): positions
patch-rescaled to the 40 um training patch where the domain is larger
(each joint keeps the fractional part of its scaled position, each grain
its position mod 1), features in float32, the jj list's live columns."""

from __future__ import annotations

import numpy as np


def lane_state(x, edges, mask, lxd: float, patch_size: float):
    xg = np.array(x["grain"], np.float64)
    xj = np.array(x["joint"], np.float64)
    factor = lxd / patch_size
    if factor > 1:
        xg[:, :2] *= factor
        xj[:, :2] *= factor
        xj[:, :2] -= np.floor(xj[:, :2])
        xg[:, :2] -= xg[:, :2] - xg[:, :2] % 1
    connect = np.asarray(edges["connect"], np.int64)
    connect = connect[:, connect[0] > -1]
    return {"xg": xg.astype(np.float32), "xj": xj.astype(np.float32),
            "E_pp": connect, "E_pq": np.asarray(edges["pull"], np.int64),
            "mask_g": np.asarray(mask["grain"]).reshape(-1),
            "mask_j": np.asarray(mask["joint"]).reshape(-1),
            "n_pp": connect.shape[1]}
