"""The port's host-side modules against the JAX package's on the CPU:
graph/state.build_ell_device (slot-equal to JAX's and to the host
build_ell), utils/profiling (the cost models exactly equal; the peaks, the
trace and its spans), data/torch_bridge (state_dicts key- and value-equal
to JAX's for the same weights, and the round trip through `.pt`),
viz/volume.GrainVisual.reconstruct (the same VTK bytes as JAX's on a
small synthetic PF file), viz/paraview_batch (the same call log on
tests/test_viz.py's FakePV) and viz/plots (each plot writes its png;
aggregate_event_stats equals JAX's)."""

import os
import subprocess
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graingraphnn_torch.data import torch_bridge as tbridge
from graingraphnn_torch.graph import state as tstate
from graingraphnn_torch.models import grain_nn as tgrain_nn
from graingraphnn_torch.models import hyper as thyper
from graingraphnn_torch.train import checkpoint
from graingraphnn_torch.utils import profiling as tprof
from graingraphnn_torch.viz import paraview_batch as tpb
from graingraphnn_torch.viz import plots as tplots
from graingraphnn_torch.viz import volume as tvolume
from graingraphnn_tpu.data import torch_bridge as jbridge
from graingraphnn_tpu.graph import state as jstate
from graingraphnn_tpu.models import grain_nn, hyper
from graingraphnn_tpu.utils import profiling as jprof
from graingraphnn_tpu.viz import paraview_batch as jpb
from graingraphnn_tpu.viz import plots as jplots
from graingraphnn_tpu.viz import volume as jvolume
from tests.test_viz import FakePV

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def coo(seed, E=240, N=48, n_src=40, dead=0.15):
    """A padded COO edge list: -1 in dead columns, degrees up to ~8."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n_src, E).astype(np.int32)
    dst = rng.integers(0, N, E).astype(np.int32)
    cut = rng.uniform(size=E) < dead
    src[cut] = -1
    dst[rng.uniform(size=E) < dead / 2] = -1
    return src, dst, rng.uniform(0.01, 0.2, E).astype(np.float32), N


@pytest.mark.parametrize("seed,max_deg", [(0, 16), (1, 12), (2, 4)])
def test_build_ell_device_matches_jax_and_host(seed, max_deg):
    """Slot for slot JAX's build_ell_device; where no destination
    overflows, also the host build_ell. At max_deg 4 the overflow edges
    are dropped, as JAX's are."""
    src, dst, attr, N = coo(seed)
    ours = [t.numpy() for t in tstate.build_ell_device(
        torch.from_numpy(src), torch.from_numpy(dst), torch.from_numpy(attr),
        N, max_deg)]
    theirs = jstate.build_ell_device(jnp.asarray(src), jnp.asarray(dst),
                                     jnp.asarray(attr), N, max_deg)
    for a, b in zip(ours, theirs):
        assert a.dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, np.asarray(b))
    live = (src >= 0) & (dst >= 0)
    if np.bincount(dst[live], minlength=N).max() <= max_deg:
        host = tstate.build_ell(src, dst, attr, N, max_deg)
        for a, b in zip(ours, host):
            np.testing.assert_array_equal(a, b)
    else:
        with pytest.raises(ValueError, match="overflow"):
            tstate.build_ell(src, dst, attr, N, max_deg)


@pytest.mark.parametrize("args", [(10, 20, 3, 5, 6, 4, 8),
                                  (1043, 2086, 16, 104, 107, 4, 96),
                                  (7, 3, 1, 3, 3, 1, 1, 2)])
def test_conv_cost_equals_jax(args):
    assert tprof.conv_cost(*args) == jprof.conv_cost(*args)


@pytest.mark.parametrize("args", [(16, 32, 16, 11, 8, 8),
                                  (1043, 2086, 16, 11, 8, 96, 2)])
def test_model_forward_cost_equals_jax(args):
    assert tprof.model_forward_cost(*args) == jprof.model_forward_cost(*args)


def test_roofline_chip_spec_and_timers(tmp_path):
    """The H100 datasheet peaks are chip_smoke's; trace(logdir) writes a Chrome trace holding a range of each
    span opened inside it, and spans.json with the spans, the clock anchor
    and the counters filed."""
    import json

    import chip_smoke

    assert (tprof.H100_PEAK_FP32, tprof.H100_PEAK_TF32X3,
            tprof.H100_PEAK_BF16, tprof.H100_PEAK_BYTES) == (
        chip_smoke.PEAK_FP32, chip_smoke.PEAK_TF32X3, chip_smoke.PEAK_BF16,
        chip_smoke.PEAK_BYTES)
    with tprof.trace(str(tmp_path / "tr")) as prof:
        with tprof.span(tprof.BUILD, lanes=1):
            with tprof.span("graingnn.product"):
                torch.ones(64, 64) @ torch.ones(64, 64)
            tprof.recorder().count({"events": 3})
    assert tprof.recorder() is None
    assert any("mm" in e.key for e in prof.key_averages())
    with open(tmp_path / "tr" / "trace.json") as f:
        ranges = [e["name"] for e in json.load(f)["traceEvents"]
                  if e.get("cat") == "user_annotation"]
    assert ranges.count(tprof.BUILD) == ranges.count("graingnn.product") == 1
    with open(tmp_path / "tr" / "spans.json") as f:
        saved = json.load(f)
    assert [(s["name"], s["parent"], s["build"]) for s in saved["spans"]] \
        == [(tprof.BUILD, -1, 0), ("graingnn.product", 0, 0)]
    assert saved["spans"][0]["attrs"] == {"lanes": 1, "index": 0}
    assert saved["counters"] == {"0": {"events": 3}}
    assert set(saved["anchor"]) == {"perf_counter_ns", "time_ns"}


def test_new_modules_import_no_jax():
    """The port's new modules leave jax out of sys.modules."""
    code = ("import sys; import graingraphnn_torch.parallel.partition, "
            "graingraphnn_torch.parallel.data_parallel, "
            "graingraphnn_torch.cli.dist_train, "
            "graingraphnn_torch.utils.profiling, "
            "graingraphnn_torch.data.torch_bridge, "
            "graingraphnn_torch.viz.paraview_batch; "
            "print(any(m == 'jax' or m.startswith('jax.') or "
            "m.startswith('graingraphnn_tpu') for m in sys.modules))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "False", out.stderr


@pytest.mark.parametrize("make", ["regressor", "classifier_transfered"])
def test_torch_bridge_matches_jax(make, tmp_path):
    """The same weights give key- and value-equal state_dicts in both
    packages; the port's `.pt` loads back into the same weights, and JAX's
    loader reads it as the JAX tree."""
    hp = getattr(hyper, make)(1 if "classifier" in make else 0,
                              layer_size=8)
    thp = getattr(thyper, make)(hp.model_id, layer_size=8)
    init = (grain_nn.init_regressor if make == "regressor"
            else grain_nn.init_classifier)
    params = init(jax.random.PRNGKey(3), hp)
    model = checkpoint.params_from_jax(params, thp, "cpu")
    ours = tbridge.to_state_dict(model)
    theirs = (jbridge.regressor_to_state_dict if make == "regressor"
              else jbridge.classifier_to_state_dict)(params, hp)
    assert list(ours) == list(theirs)
    for k in theirs:
        assert ours[k].shape == theirs[k].shape, k
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)
    pt = str(tmp_path / "m.pt")
    tbridge.save_torch_checkpoint(pt, model)
    back = tbridge.load_torch_checkpoint(pt, thp)
    for (n, a), (_, b) in zip(model.named_parameters(),
                              back.named_parameters()):
        np.testing.assert_array_equal(a.detach().numpy(),
                                      b.detach().numpy(), err_msg=n)
    jtree = jbridge.load_torch_checkpoint(pt, hp)
    flat = checkpoint._flatten(jtree)
    for n, p in model.named_parameters():
        np.testing.assert_array_equal(np.asarray(flat[n]),
                                      p.detach().numpy(), err_msg=n)


def test_torch_bridge_refuses_unbridged_configs():
    """The edge-length head and stacked layers have no reference
    counterpart, as in JAX's bridge."""
    for hp in (thyper.regressor(0, layer_size=8, edge_len=True),
               thyper.regressor(0, layer_size=8, layers=2)):
        with pytest.raises(NotImplementedError):
            tbridge.to_state_dict(tgrain_nn.build(hp))


def pf_file(directory, seed=7, fnx=10, fny=8, frames=25, n_grains=6):
    """A small synthetic PF file: cross-section grain ids for every
    frame, the angles of n_grains grains."""
    rng = np.random.default_rng(seed)
    path = os.path.join(directory, f"Epita_seed{seed}_frames{frames - 1}.h5")
    with h5py.File(path, "w") as f:
        f["x_coordinates"] = np.linspace(0, 4.5, fnx)
        f["y_coordinates"] = np.linspace(0, 3.5, fny)
        f["z_coordinates"] = np.linspace(0, 5.0, 12)
        f["angles"] = rng.uniform(0, np.pi / 2, 2 * n_grains + 1)
        f["cross_sec"] = rng.integers(1, n_grains + 1,
                                      fnx * fny * frames).astype(np.int32)
    return path


@pytest.mark.parametrize("fields", [False, True])
def test_reconstruct_writes_jax_bytes(tmp_path, fields):
    pf_file(str(tmp_path))
    kw = dict(lxd=40, seed=7, height=20, base_width=2)
    fl = None
    if fields:
        rng = np.random.default_rng(1)
        fl = [rng.integers(1, 7, (8, 6)) for _ in range(5)]
    a = tvolume.GrainVisual(**kw).reconstruct(
        str(tmp_path), span=4, alpha_field_list=fl,
        out=str(tmp_path / "ours.vtk"))
    b = jvolume.GrainVisual(**kw).reconstruct(
        str(tmp_path), span=4, alpha_field_list=fl,
        out=str(tmp_path / "theirs.vtk"))
    with open(a, "rb") as fa, open(b, "rb") as fb:
        ours, theirs = fa.read(), fb.read()
    assert ours == theirs and len(ours) > 200
    default = tvolume.GrainVisual(**kw).reconstruct(str(tmp_path), span=4)
    assert default == f"{tmp_path}/seed7leapz.vtk"


@pytest.mark.parametrize("kw", [dict(clip=False),
                                dict(clip=True, threshold=(3.0, 9.0)),
                                dict(clip=False, threshold=(1.0, 2.0),
                                     surface_opacity=0.3)])
def test_paraview_pipeline_matches_jax(kw):
    """build_pipeline, render_image and render_video_frames make the same
    calls on FakePV in both packages."""
    logs = []
    for mod in (tpb, jpb):
        pv = FakePV()
        view = mod.build_pipeline(pv, "a.vtk", **kw)
        mod.render_image(pv, view, "a.png", 64)
        mod.render_video_frames(pv, view, "out", frames=3, resolution=32)
        logs.append((pv.log, view.ViewSize, pv.disp.Opacity,
                     [c[0] for c in pv.lut.calls]))
    assert logs[0] == logs[1]


def test_paraview_cli_exits_without_paraview(monkeypatch):
    monkeypatch.setitem(sys.modules, "paraview", None)
    monkeypatch.setitem(sys.modules, "paraview.simple", None)
    with pytest.raises(SystemExit) as ei:
        tpb.main(["missing.vtk"])
    assert "paraview.simple" in str(ei.value)


def test_plots_write_pngs(tmp_path):
    rng = np.random.default_rng(0)
    p = lambda name: str(tmp_path / f"{name}.png")
    h5 = pf_file(str(tmp_path))
    outs = [
        tplots.loss_curves([1.0, 0.5, 0.2], [1.1, 0.6, 0.3], p("loss"),
                           title="t"),
        tplots.pr_curve([0.9, 0.8], [0.1, 0.5], p("pr")),
        tplots.size_distribution(rng.uniform(1, 15, 50), p("size"),
                                 truth_sizes=rng.uniform(1, 15, 50)),
        tplots.event_accuracy([(2, 1, 1, 0), (4, 3, 2, 2)], p("events")),
        tplots.layer_error([(2, 0.1), (4, 0.2)], p("layer")),
        tplots.misorientation([2, 4], {"PF": [1, 2], "GNN": [1.5, 2.5]},
                              p("mis")),
        tplots.snapshot_grid([rng.integers(0, 5, (6, 4)) for _ in range(3)],
                             p("grid"), titles=["a", "b", "c"]),
        tplots.snapshot_grid_from_h5(h5, p("h5grid"), frames=[0, 3]),
    ]
    for o in outs:
        with open(o, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n", o


def test_aggregate_event_stats_equals_jax():
    names = ["res_elimp12_t15.json", "x_elimp3_t4_G1.pkl", "nothing.txt",
             "elimp0_t9"]
    assert tplots.aggregate_event_stats(names) == \
        jplots.aggregate_event_stats(names) == (15, 28)
