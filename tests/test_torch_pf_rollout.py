"""cli.test without --generate, on the port and on the JAX package, from
the same synthetic phase-field file (chip_smoke's, 121 frames, written
with h5py) with the shipped checkpoints on the CPU:

- the CLI over one span on the host engine, with --jit_editor and with
  --device_resident: the JSON lines equal, floats within QOI_RTOL;
- run_device_resident(compare=True) over one chunk of two spans: the
  layer errors, event hits and KS of JAX's driver (its fused editor, run
  as the JAX package's tests run it on the CPU), within QOI_RTOL;
- --plot3D writes the VTK file JAX's GrainVisual.graph_recon writes from
  the same fields, byte for byte;
- compare=True without a truth, and --plot3D with --device_resident, are
  refused.
"""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

import chip_smoke
from graingraphnn_torch.cli import test as tcli
from graingraphnn_torch.data import extraction as tx
from graingraphnn_torch.kernels import editor_fused
from graingraphnn_torch.rollout import device_driver as dd
from graingraphnn_torch.train import checkpoint
from graingraphnn_torch.viz import volume as tvol
from graingraphnn_tpu.cli import test as jcli
from graingraphnn_tpu.data import extraction as jx
from graingraphnn_tpu.rollout import device_driver as jdd
from graingraphnn_tpu.train import checkpoint as jck
from graingraphnn_tpu.viz import volume as jvol
from tests.test_torch_device_rollout import REPO

QOI_RTOL = 1e-5
ONE_SPAN = "2.6"      # int(2.6 / 0.4) = 6 frames: one span of 6
THRESHOLD = 0.9
MODELS = os.path.join(REPO, "artifacts", "40um")


@pytest.fixture(scope="module")
def pf_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("rawdat")
    chip_smoke.write_pf_file(d, chip_smoke.synthetic_pf_arrays())
    return str(d)


def cli_line(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(argv)
    return json.loads(out.getvalue().strip().splitlines()[-1])


def same_line(jl, tl):
    assert set(tl) == set(jl)
    for k in ("events_tp", "events_truth", "events_pred"):
        assert tl[k] == jl[k], k
    for k in ("final_layer_error", "mean_layer_error", "KS"):
        assert tl[k] is not None, k
        np.testing.assert_allclose(tl[k], jl[k], rtol=QOI_RTOL, err_msg=k)


@pytest.mark.parametrize("extra", [[], ["--jit_editor"], ["--device_resident"]])
def test_cli_on_pf_data_matches_jax(pf_dir, tmp_path, extra):
    argv = ["--platform", "cpu", "--model_dir", MODELS, "--rawdat_dir",
            pf_dir, "--cache_dir", str(tmp_path), "--seed", "10020",
            "--growth_height", ONE_SPAN, "--c_threshold", str(THRESHOLD)]
    jextra = extra + (["--fused_editor", "on"] if "--device_resident" in extra
                      else [])
    same_line(cli_line(jcli.main, argv + jextra),
              cli_line(tcli.main, argv + extra))


def extracted(mod, pf_dir, cache):
    traj = mod.TrajectoryExtractor(lxd=40, seed=10020, frames=121)
    traj.match_graph = False
    traj.extract(pf_dir, cache_dir=str(cache))
    return traj, mod.make_test_sample(traj, span=6)


def test_device_driver_compare_matches_jax(pf_dir, tmp_path, monkeypatch):
    """One chunk of two spans with compare on: every result key of JAX's
    driver, the switch probabilities checked against the threshold (an
    event within 1e-5 of it may flip on one ulp of the sigmoid)."""
    jt, jh = extracted(jx, pf_dir, tmp_path)
    tt, th = extracted(tx, pf_dir, tmp_path)
    pr, hpr, _ = jck.load(MODELS + "/regressor0")
    pc, hpc, _ = jck.load(MODELS + "/classifier1")
    reg = checkpoint.params_from_jax(pr, hpr, "cpu")
    cls = checkpoint.params_from_jax(pc, hpc, "cpu")
    kw = dict(span=6, c_threshold=THRESHOLD, eval_every=2,
              growth_height=5.0, compare=True)
    ref = jdd.run_device_resident(jh, jt, pr, hpr, pc, hpc,
                                  fused_editor=True, **kw)
    probs = []
    update = editor_fused.update_fused
    monkeypatch.setattr(editor_fused, "update_fused", lambda *a, **k: (
        probs.append(torch.sigmoid(a[1])), update(*a, **k))[1])
    out = dd.run_device_resident(dd.trajectory_from_extractor(tt, th), reg,
                                 cls, device="cpu", **kw)
    near = any(bool(((p - THRESHOLD).abs() < 1e-5).any()) for p in probs)
    assert not near
    assert out.keys() == ref.keys()
    assert len(out["layer_err_list"]) == 2 and out["KS"] is not None
    for k in ref:
        if k == "inference_time":
            continue
        if k in ("misorientation", "KS", "KS_p", "size_err",
                 "mean_layer_error", "final_layer_error"):
            np.testing.assert_allclose(out[k], ref[k], rtol=QOI_RTOL,
                                       err_msg=k)
        elif k == "layer_err_list":
            assert [h for h, _ in out[k]] == [h for h, _ in ref[k]]
            np.testing.assert_allclose([e for _, e in out[k]],
                                       [e for _, e in ref[k]], rtol=QOI_RTOL)
        else:
            assert out[k] == ref[k], k


def test_plot3d_writes_the_jax_volume(pf_dir, tmp_path, monkeypatch):
    """--plot3D on the host engine over one span writes seed10020graph.vtk
    in the working directory: the bytes JAX's graph_recon writes from the
    same arguments."""
    calls = []
    recon = tvol.GrainVisual.graph_recon

    def keep(self, *a, **k):
        calls.append((dict(vars(self)), a, k))
        return recon(self, *a, **k)

    monkeypatch.setattr(tvol.GrainVisual, "graph_recon", keep)
    monkeypatch.chdir(tmp_path)
    line = cli_line(tcli.main, [
        "--platform", "cpu", "--model_dir", MODELS, "--rawdat_dir", pf_dir,
        "--cache_dir", str(tmp_path), "--seed", "10020", "--growth_height",
        ONE_SPAN, "--plot3D"])
    assert line["final_layer_error"] is not None
    (init, a, k), = calls
    assert len(a[1]) == 2            # the fields of frame 0 and one span
    jv = jvol.GrainVisual(**init)
    jv.graph_recon(*a, **dict(k, out=str(tmp_path / "jax.vtk")))
    ours = (tmp_path / "seed10020graph.vtk").read_bytes()
    assert ours == (tmp_path / "jax.vtk").read_bytes()
    assert ours.startswith(b"# vtk DataFile Version 3.0")


def test_compare_without_a_truth_is_refused():
    traj = dd.generate_trajectory(40, 3, 4.0, 1.0)
    with pytest.raises(ValueError, match="truth"):
        dd.run_device_resident(traj, None, None, compare=True, device="cpu")


def test_cli_refuses_plot3d_on_the_device_path(pf_dir):
    with pytest.raises(SystemExit):
        tcli.main(["--platform", "cpu", "--model_dir", MODELS,
                   "--rawdat_dir", pf_dir, "--device_resident", "--plot3D"])


def test_grain_visual_load_matches_jax(tmp_path):
    """GrainVisual.load on a PF file with a 3D grain-id field and the
    grains' angles (written here): the port's VTK file is JAX's, byte for
    byte."""
    import h5py

    rng = np.random.default_rng(2)
    n, nz, grains = 12, 9, 7
    alpha = rng.integers(1, grains + 1, (n + 2, n + 2, nz))
    d = tmp_path / "rawdat"
    d.mkdir()
    with h5py.File(d / "pf_seed4_G2.0_Rmax0.4_frames120.h5", "w") as f:
        f["x_coordinates"] = (np.arange(n + 2) - 1) * 0.5
        f["y_coordinates"] = (np.arange(n + 2) - 1) * 0.5
        f["z_coordinates"] = np.arange(nz) * 0.5
        f["alpha"] = alpha.ravel(order="F")
        f["angles"] = rng.uniform(0, np.pi / 2, 2 * grains + 1)
    out = []
    for mod in (jvol, tvol):
        path = str(tmp_path / f"{mod.__name__.split('.')[0]}.vtk")
        mod.GrainVisual(lxd=5, seed=4, height=3.0).load(str(d), out=path)
        out.append(open(path, "rb").read())
    assert out[0] == out[1]
    assert f"DIMENSIONS {n} {n} 5".encode() in out[1]
