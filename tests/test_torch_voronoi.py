"""The port's seeded Voronoi generator (graph/voronoi, data/extraction)
against the JAX package's: the lattices from the same seed, and whole
Microstructures (vertices, regions, edges, quadruples, raster, areas,
orientations, grain sizes) for periodic and no-flux graphs, the adjusted
grain size and orientation, and user-defined configs. The port draws from
its own RandomState and leaves numpy's global state alone; its generator,
raster and CLI run with PIL and h5py unimportable."""

import os
import subprocess
import sys

import numpy as np
import pytest

from graingraphnn_torch.data import extraction as tex
from graingraphnn_torch.graph import voronoi as tv
from graingraphnn_tpu.data import extraction as jex
from graingraphnn_tpu.graph import voronoi as jv
from tests.test_torch_device_rollout import REPO

DICTS = ("vertices", "vertex2joint", "joint2vertex", "edges", "quadruples",
         "regions", "region_coors", "region_center", "corner_grains",
         "area_counts", "imagesize")
ARRAYS = ("alpha_field", "theta_x", "theta_z", "ini_grain_dis")
SCALARS = ("num_regions", "num_vertices", "num_edges", "lxd", "lyd",
           "max_y", "mesh_size", "ini_height", "final_height", "density",
           "noise", "patch_size")


def user_config(bc, asp):
    return {"boundary": bc,
            "geometry": {"lxd": 40, "yx_asp_ratio": asp, "zx_asp_ratio": 1.0,
                         "z0": 2, "cone_ratio": 0.0},
            "initial_parameters": {"mesh_size": 0.08, "grain_size_mean": 4,
                                   "seed": 9, "noise_level": 0.01},
            "physical_parameters": {"G": 3.0, "R": 1.5}}


CASES = {
    "periodic-40-3": dict(lxd=40, seed=3),
    "periodic-120-5": dict(lxd=120, seed=5),
    "noflux-40-1": dict(lxd=40, seed=1, bc="noflux"),
    "adjusted-60-7": dict(lxd=60, seed=7, adjust_grain_size=True,
                          adjust_grain_orien=True),
    "noflux-adjusted-40-11": dict(lxd=40, seed=11, bc="noflux",
                                  adjust_grain_orien=True),
    "user-periodic": dict(user_defined_config=user_config("periodic", 1.0)),
    "user-noflux": dict(user_defined_config=user_config("noflux", 0.75)),
}


def assert_same_graph(a, b):
    for k in DICTS + SCALARS:
        assert getattr(a, k) == getattr(b, k), k
    for k in ARRAYS:
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_microstructure_matches_jax(name):
    kw = CASES[name]
    ref = jv.Microstructure(**kw)
    state = np.random.get_state()
    out = tv.Microstructure(**kw)
    after = np.random.get_state()
    assert_same_graph(out, ref)
    assert all(np.array_equal(x, y) for x, y in zip(state, after))


@pytest.mark.parametrize("lattice,bc", [("hexagonal_lattice", "periodic"),
                                        ("hexagonal_lattice", "noflux"),
                                        ("random_lattice", "periodic"),
                                        ("random_lattice", "noflux")])
def test_lattices_match_jax(lattice, bc):
    kw = dict(dx=0.1, noise=1e-3, bc=bc, max_y=0.8, cone_ratio=0.05)
    np.random.seed(4)
    ref = getattr(jv, lattice)(**kw)
    out = getattr(tv, lattice)(np.random.RandomState(4), **kw)
    assert out == ref


def test_trajectory_extractor_matches_jax():
    kw = dict(lxd=40, seed=3, frames=61, physical_params={"G": 4, "R": 1})
    ref = jex.TrajectoryExtractor(**kw)
    out = tex.TrajectoryExtractor(**kw)
    assert_same_graph(out, ref)
    for k in ("physical_params", "frames", "train_test_frame_ratio",
              "load_frames", "match_graph", "save_frame", "edge_events",
              "grain_events", "area_traj"):
        assert getattr(out, k) == getattr(ref, k), k
    cfg = user_config("periodic", 1.0)
    out = tex.TrajectoryExtractor(user_defined_config=cfg)
    assert out.physical_params == cfg["physical_parameters"]
    assert_same_graph(out, jex.TrajectoryExtractor(user_defined_config=cfg))


GUARD = """
import sys
for name in ("PIL", "PIL.Image", "PIL.ImageDraw", "h5py", "jax"):
    sys.modules[name] = None
from graingraphnn_torch.cli import test as cli
from graingraphnn_torch.rollout import device_driver as dd
traj = dd.generate_trajectory(40, 3, 4.0, 1.0)
assert traj.num_regions == 117, traj.num_regions
cli.main(["--platform", "cpu", "--generate", "--device_resident",
          "--model_dir", sys.argv[1], "--lxd", "40", "--seed", "3",
          "--G", "4", "--R", "1", "--growth_height", "5.0"])
bad = [m for m in sys.modules if m.split(".")[0] in
       ("graingraphnn_tpu", "jax", "PIL", "h5py") and sys.modules[m]]
assert not bad, bad
"""


def test_generator_raster_and_cli_run_without_pil_and_h5py():
    """The card's machine has neither PIL nor h5py: the generator, the
    raster (frame 0 and the driver's reconstruction) and the CLI import
    and run with both blocked, and without JAX."""
    out = subprocess.run(
        [sys.executable, "-c", GUARD, os.path.join(REPO, "artifacts/40um")],
        cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert '"events_pred"' in out.stdout.splitlines()[-1]
