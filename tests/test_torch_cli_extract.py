"""The port's cli.extract and cli.merge against the JAX package's CLIs
on the same synthetic phase-field file (chip_smoke's, 13 frames, written
with h5py): train, test (with --span, and with the span looked up in a
--gr_grid table written here), generate (with and without --user_config)
and check modes write equal pickles or print equal lines, and the two
merges of the same files are equal."""

import contextlib
import io
import os
import pickle
import sys

import numpy as np
import pytest

import chip_smoke
from graingraphnn_torch.cli import extract as textract
from graingraphnn_torch.cli import merge as tmerge
from graingraphnn_torch.data import thermal
from graingraphnn_tpu.cli import extract as jextract
from graingraphnn_tpu.cli import merge as jmerge

FRAMES = 13


@pytest.fixture(scope="module")
def pf_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("rawdat")
    chip_smoke.write_pf_file(d, chip_smoke.synthetic_pf_arrays(FRAMES))
    return str(d)


@pytest.fixture(scope="module")
def gr_grid(tmp_path_factory):
    path = tmp_path_factory.mktemp("grid") / "GR_train_grid.pkl"
    grid = thermal.build_gr_grid([(1.0, 0.2, 6), (2.0, 0.6, 8), (4.0, 1.0, 10),
                                  (8.0, 1.8, 12)])
    with open(path, "wb") as f:
        pickle.dump(grid, f)
    return str(path)


def run_both(args, tmp_path, monkeypatch):
    """Each package's CLI with args and its own --save_dir; returns the
    two directories and the two standard outputs."""
    dirs, outs = [], []
    for name, main in (("jax", None), ("torch", textract.main)):
        d = tmp_path / name
        argv = args + ["--save_dir", str(d), "--cache_dir",
                       str(tmp_path / "cache")]
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            if main is None:
                monkeypatch.setattr(sys, "argv", ["extract"] + argv)
                jextract.main()
            else:
                main(argv)
        dirs.append(d)
        outs.append(out.getvalue().replace(str(d), "<save_dir>"))
    return dirs, outs


def same(a, b):
    assert type(a) is type(b) or (np.isscalar(a) and np.isscalar(b)), (
        type(a), type(b))
    if isinstance(a, dict):
        assert list(a) == list(b)
        for k in a:
            same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same(x, y)
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def same_pickles(dirs):
    jfiles, tfiles = (sorted(os.listdir(d)) for d in dirs)
    assert jfiles == tfiles and len(tfiles) == 1
    loaded = []
    for d in dirs:
        with open(d / tfiles[0], "rb") as f:
            loaded.append(pickle.load(f))
    same(*loaded)
    return tfiles[0], loaded[1]


@pytest.mark.parametrize("extra", [[], ["--prev", "1", "--span", "8"]])
def test_train_mode_matches_jax(pf_dir, tmp_path, monkeypatch, extra):
    dirs, outs = run_both(["--mode", "train", "--rawdat_dir", pf_dir,
                           "--seed", "10020", "--frame", str(FRAMES)] + extra,
                          tmp_path, monkeypatch)
    assert outs[0] == outs[1]
    name, payload = same_pickles(dirs)
    assert name.startswith("seed10020_G19_R5_span") and name.endswith("_train.pkl")
    assert len(payload) > 0 and set(payload[0]) == {
        "feature_dicts", "target_dicts", "edge_index_dicts",
        "edge_weight_dicts", "mask", "physical_params", "span"}


@pytest.mark.parametrize("span", [["--span", "6"], []])
def test_test_mode_matches_jax(pf_dir, gr_grid, tmp_path, monkeypatch, span):
    dirs, outs = run_both(["--mode", "test", "--rawdat_dir", pf_dir,
                           "--seed", "10020", "--frame", str(FRAMES),
                           "--gr_grid", gr_grid] + span,
                          tmp_path, monkeypatch)
    assert outs[0] == outs[1]
    name, payload = same_pickles(dirs)
    assert name == f"seed10020_G1.904_R0.558_span{payload[0]['span']}.pkl"
    assert len(payload) == 1


def test_check_mode_matches_jax(pf_dir, tmp_path, monkeypatch):
    _, outs = run_both(["--mode", "check", "--rawdat_dir", pf_dir, "--seed",
                        "10020", "--frame", str(FRAMES)], tmp_path,
                       monkeypatch)
    assert outs[0] == outs[1] and outs[1].startswith("extracted 13 frames;")


@pytest.mark.parametrize("extra", [["--span", "6"], ["--user_config"]])
def test_generate_mode_matches_jax(gr_grid, tmp_path, monkeypatch, extra):
    dirs, outs = run_both(["--mode", "generate", "--seed", "5", "--G", "4",
                           "--R", "1", "--gr_grid", gr_grid] + extra,
                          tmp_path, monkeypatch)
    assert outs[0] == outs[1]
    same_pickles(dirs)


def test_merge_matches_jax(pf_dir, tmp_path, monkeypatch):
    """Both merges of the same two training pickles (one per seed file
    name), shuffled with the default seed."""
    src = tmp_path / "src"
    for extra in ([], ["--span", "8"]):
        textract.main(["--mode", "train", "--rawdat_dir", pf_dir, "--seed",
                       "10020", "--frame", str(FRAMES), "--save_dir",
                       str(src), "--cache_dir", str(tmp_path / "cache")]
                      + extra)
    outs = []
    for name, main in (("jax", jmerge.main), ("torch", tmerge.main)):
        out = str(tmp_path / f"{name}.pkl")
        with contextlib.redirect_stdout(io.StringIO()):
            main(["--glob", str(src / "seed*_train.pkl"), "--out", out])
        with open(out, "rb") as f:
            outs.append(pickle.load(f))
    same(*outs)
    assert len(outs[1]) > 2


def test_missing_pf_file_is_an_argument_error(tmp_path):
    with pytest.raises(SystemExit):
        textract.main(["--mode", "train", "--rawdat_dir", str(tmp_path),
                       "--seed", "10020", "--save_dir", str(tmp_path)])
