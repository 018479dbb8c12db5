"""The committed 120 um starting graph (graingraphnn_torch/data/gen120_seed5.npz)
must equal a fresh generation through the JAX package's own pipeline: the
generate-mode Voronoi graph of bench.py (seed 5, G=1.904, R=0.558) reduced
to the host arrays that the port's init_scaled_state takes.

Write the fixture anew with `python -m tests.test_torch_fixture`."""

import numpy as np
import pytest

from graingraphnn_torch.rollout import device_driver as tdd
from graingraphnn_tpu.graph import schema

LXD, SEED = 120, 5


def generate(lxd=LXD, seed=SEED):
    """The arrays that device_driver.init_scaled_state reads from hg0/traj
    (bench.py:_real_state), as plain numpy."""
    from graingraphnn_tpu.data import extraction, heterograph

    traj = extraction.TrajectoryExtractor(
        lxd=lxd, seed=seed, frames=121, bc="periodic",
        physical_params={"G": 1.904, "R": 0.558},
    )
    traj.area_counts = dict(zip(*np.unique(traj.alpha_field,
                                           return_counts=True)))
    traj.area_traj.append(dict(traj.area_counts))
    traj.states.append(heterograph.tensorize(traj, 0))
    hg0 = extraction.make_test_sample(traj, span=6)
    return {
        "x_grain": np.asarray(hg0.feature_dicts["grain"], np.float64),
        "x_joint": np.asarray(hg0.feature_dicts["joint"], np.float64),
        "edges_pull": np.asarray(
            hg0.edge_index_dicts[schema.EDGE_TYPES[1]], np.int32),
        "edges_connect": np.asarray(
            hg0.edge_index_dicts[schema.EDGE_TYPES[2]], np.int32),
        "mask_grain": np.asarray(hg0.mask["grain"], np.int32).reshape(-1),
        "lxd": np.float64(traj.lxd),
        "patch_size": np.float64(traj.patch_size),
    }


@pytest.fixture(scope="module")
def fresh():
    return generate()


def test_fixture_matches_fresh_generation(fresh):
    with np.load(tdd.FIXTURE_120) as z:
        stored = {k: z[k] for k in z.files}
    assert sorted(stored) == sorted(fresh)
    for k, v in fresh.items():
        assert stored[k].dtype == v.dtype, k
        np.testing.assert_array_equal(stored[k], v, err_msg=k)


def test_fixture_loads_as_host_arrays(fresh):
    x, edges, mask, lxd, patch = tdd.load_fixture()
    assert (lxd, patch) == (float(fresh["lxd"]), float(fresh["patch_size"]))
    np.testing.assert_array_equal(x["joint"], fresh["x_joint"])
    np.testing.assert_array_equal(edges["pull"], fresh["edges_pull"])
    assert mask["joint"].shape == (fresh["x_joint"].shape[0],)
    assert int(mask["joint"].sum()) == fresh["x_joint"].shape[0]


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(tdd.FIXTURE_120, **generate())
    print("wrote", tdd.FIXTURE_120)
