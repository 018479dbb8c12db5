"""The committed 120 um starting graph (graingraphnn_torch/data/gen120_seed5.npz)
must equal a fresh generation through the JAX package's own pipeline: the
generate-mode Voronoi graph of bench.py (seed 5, G=1.904, R=0.558) reduced
to the host arrays that the port's init_scaled_state takes.

Write the fixture anew with `python -m tests.test_torch_fixture`."""

import numpy as np
import pytest

from graingraphnn_torch.rollout import device_driver as tdd
from graingraphnn_tpu.graph import schema

LXD, SEED, G, R = 120, 5, 1.904, 0.558


def jax_start(lxd=LXD, seed=SEED, G=G, R=R):
    """The JAX package's generate-mode trajectory and its t=0 sample
    (bench.py:_real_state): (traj, hg0)."""
    from graingraphnn_tpu.data import extraction, heterograph

    traj = extraction.TrajectoryExtractor(
        lxd=lxd, seed=seed, frames=121, bc="periodic",
        physical_params={"G": G, "R": R},
    )
    traj.area_counts = dict(zip(*np.unique(traj.alpha_field,
                                           return_counts=True)))
    traj.area_traj.append(dict(traj.area_counts))
    traj.states.append(heterograph.tensorize(traj, 0))
    return traj, extraction.make_test_sample(traj, span=6)


def generate(lxd=LXD, seed=SEED, G=G, R=R):
    """The fixture's arrays of a fresh JAX trajectory."""
    return fixture_arrays(*jax_start(lxd, seed, G, R), G, R, seed)


def fixture_arrays(traj, hg0, G, R, seed):
    """The arrays that device_driver.init_scaled_state reads from hg0/traj,
    and the trajectory metadata that the JAX driver's generate mode reads
    from traj, as plain numpy."""
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
        "theta_z": np.asarray(traj.theta_z, np.float64),
        "area_ids": np.asarray(list(traj.area_traj[0]), np.int64),
        "area_counts": np.asarray(list(traj.area_traj[0].values()),
                                  np.int64),
        "num_regions": np.int64(traj.num_regions),
        "mesh_size": np.float64(traj.mesh_size),
        "ini_height": np.float64(traj.ini_height),
        "final_height": np.float64(traj.final_height),
        "G": np.float64(G),
        "R": np.float64(R),
        "seed": np.int64(seed),
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


def test_trajectory_metadata_loads(fresh):
    """The metadata the port's driver reads (device_driver.load_trajectory)
    is the JAX trajectory's: orientations, frame-0 areas, heights."""
    traj = tdd.load_trajectory()
    np.testing.assert_array_equal(traj.theta_z, fresh["theta_z"])
    assert traj.area0 == dict(zip(fresh["area_ids"], fresh["area_counts"]))
    assert len(traj.theta_z) == traj.num_regions + 1
    assert (traj.G, traj.R, traj.seed) == (G, R, SEED)
    assert traj.x["grain"].shape[0] == int(fresh["mask_grain"].shape[0])


def test_port_generator_reproduces_the_fixture():
    """The port's own generator (Voronoi graph, raster areas, tensorize,
    test sample) gives the committed fixture's trajectory exactly."""
    out = tdd.generate_trajectory(LXD, SEED, G, R)
    ref = tdd.load_trajectory()
    for part in ("x", "edges", "mask"):
        a, b = getattr(out, part), getattr(ref, part)
        assert a.keys() == b.keys(), part
        for k in a:
            assert a[k].dtype == b[k].dtype, (part, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{part} {k}")
    np.testing.assert_array_equal(out.theta_z, ref.theta_z)
    assert out.area0 == ref.area0
    assert [type(k) for k in out.area0] == [type(k) for k in ref.area0]
    for k in ("lxd", "patch_size", "num_regions", "mesh_size", "ini_height",
              "final_height", "G", "R", "seed", "bc", "lyd", "imagesize"):
        assert getattr(out, k) == getattr(ref, k), k


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    np.savez_compressed(tdd.FIXTURE_120, **generate())
    print("wrote", tdd.FIXTURE_120)
