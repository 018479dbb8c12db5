"""The port's symmetry augmentation against the JAX package's on a
synthetic 40 um sample: transform_sample for every rotation and
reflection (with and without a translation) and augment_group under one
numpy default_rng, array for array and bit for bit."""

import numpy as np
import pytest

from graingraphnn_torch.data import augment as taug
from graingraphnn_torch.graph import synthetic
from graingraphnn_tpu.data import augment as jaug


@pytest.fixture(scope="module")
def raw():
    f, e, w, m, t = synthetic.spatial_ring_arrays(40, seed=3)
    return {"feature_dicts": f, "target_dicts": t, "edge_index_dicts": e,
            "edge_weight_dicts": w, "mask": m}


def same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            same(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("shift", [(0.0, 0.0), (0.3125, 0.71)])
@pytest.mark.parametrize("refl", [False, True])
@pytest.mark.parametrize("k", [0, 1, 2, 3])
def test_transform_sample_matches_jax(raw, k, refl, shift):
    t = taug.transform_sample(raw, k=k, refl=refl, tx=shift[0], ty=shift[1])
    j = jaug.transform_sample(raw, k=k, refl=refl, tx=shift[0], ty=shift[1])
    same(t, j)
    if k == 0 and not refl and shift == (0.0, 0.0):
        same(t, raw)
    else:
        assert not np.array_equal(t["feature_dicts"]["joint"][:, :2],
                                  raw["feature_dicts"]["joint"][:, :2])


@pytest.mark.parametrize("flags", [
    dict(), dict(rotations=False), dict(reflections=False),
    dict(translate=False)])
def test_augment_group_matches_jax(raw, flags):
    t = taug.augment_group(raw, np.random.default_rng(7), **flags)
    j = jaug.augment_group(raw, np.random.default_rng(7), **flags)
    assert len(t) == len(j) == (4 if flags.get("rotations", True) else 1) * (
        2 if flags.get("reflections", True) else 1)
    for a, b in zip(t, j):
        same(a, b)
