"""cli.dist_train on the CPU, end to end: each --partition (dp, hybrid,
halo) for 2 epochs on 4 gloo ranks from the real entry point (finite
losses, the JAX CLI's step counts, bytes sent per rank, a checkpoint
with the optimizer's state that checkpoint.load_model reads and cli.test
runs); a run saved after epoch 1 and resumed gives epoch 2's loss of the
uninterrupted run, exactly (one more rank group runs the CLI's rank body
for the three partitions); --multihost as two processes of an env://
group on localhost; and the refusals. A 12-graph corpus of 32-grain
synthetic windows (11 train) and a width-8 config."""

import dataclasses
import json
import math
import os
import pickle
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest

from graingraphnn_torch.cli import dist_train
from graingraphnn_torch.cli import test as test_cli
from graingraphnn_torch.graph import synthetic
from graingraphnn_torch.models import hyper
from graingraphnn_torch.parallel import mesh as tmesh
from graingraphnn_torch.train import checkpoint
from tests import torch_rank_jobs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTITIONS = ("dp", "hybrid", "halo")
# 11 training graphs, batch 2: dp over 4 ranks takes 11 // 8 = 1 step an
# epoch, hybrid (dp 2 x gp 2) 11 // 4 = 2, halo one a graph
STEPS = {"dp": 1, "hybrid": 2, "halo": 11}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    raw = []
    for seed in range(12):
        f, e, w, m, t = synthetic.spatial_ring_arrays(32, seed=seed)
        raw.append({"feature_dicts": f, "target_dicts": t,
                    "edge_index_dicts": e, "edge_weight_dicts": w,
                    "mask": m})
    with open(d / "train.pkl", "wb") as fh:
        pickle.dump(raw, fh)
    hp = hyper.regressor(0, layer_size=8, batch_size=2)
    with open(d / "small.json", "w") as fh:
        json.dump(dataclasses.asdict(hp), fh)
    return str(d)


def argv(corpus):
    return ["--dataset", f"{corpus}/train.pkl", "--platform", "cpu",
            "--config", f"{corpus}/small.json"]


@pytest.fixture(scope="module")
def runs(corpus, tmp_path_factory):
    """{partition: summary} of 2-epoch runs through main()."""
    out = {}
    for part in PARTITIONS:
        d = str(tmp_path_factory.mktemp(part))
        out[part] = dist_train.main(argv(corpus) + [
            "--partition", part, "--n_devices", "4", "--epochs", "2",
            "--model_dir", d])
    return out


@pytest.mark.parametrize("part", PARTITIONS)
def test_dist_train_runs_two_epochs(runs, part):
    res = runs[part]
    assert res["ranks"] == 4 and res["epochs"] == [1, 2]
    assert all(math.isfinite(v) for v in res["train_loss"])
    assert len(res["step_ms"]) == 2 * STEPS[part]
    sent = res["bytes_sent"]
    assert sent["all_reduce"] > 0
    assert (sent["exchange"] > 0) == (part == "halo")
    assert (sent["all_gather"] > 0) == (part == "hybrid")
    model, hp, _ = checkpoint.load_model(res["checkpoint"], "cpu")
    assert hp.layer_size == 8 and hp.model_type == "regressor"
    _p, _hp, _e, saved = checkpoint.load(res["checkpoint"], opt_state=True)
    assert saved["epoch"] == 2
    assert saved["scheduler"]["last_epoch"] == 2 * STEPS[part]


def test_resumed_run_repeats_epoch_two(corpus, runs, tmp_path):
    """Epoch 1, save with the optimizer's state, resume: epoch 2's loss
    is the uninterrupted run's, for every partition."""
    res = tmesh.launch(torch_rank_jobs.run_jobs, 4, [(
        "dist_train_resume", (argv(corpus), PARTITIONS, str(tmp_path)))],
        device="cpu", threads=2, store_dir=str(tmp_path / "store"))
    got = res[0][0]
    for part in PARTITIONS:
        first, resumed = got[part]
        assert first["train_loss"] == runs[part]["train_loss"][:1], part
        assert resumed["epochs"] == [2]
        assert resumed["train_loss"] == runs[part]["train_loss"][1:], part


def test_checkpoint_runs_in_cli_test(runs, tmp_path, capsys):
    """The dp run's checkpoint, named regressor0 beside the shipped
    classifier, rolls out through cli.test (2 spans)."""
    src = runs["dp"]["checkpoint"]
    for ext in (".ckpt", ".json"):
        shutil.copy(src + ext, tmp_path / f"regressor0{ext}")
        shutil.copy(f"{REPO}/artifacts/40um/classifier1{ext}",
                    tmp_path / f"classifier1{ext}")
    test_cli.main(["--generate", "--device_resident", "--model_dir",
                   str(tmp_path), "--seed", "3", "--G", "4", "--R", "1",
                   "--eval_every", "5", "--growth_height", "4.8",
                   "--platform", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["events_pred"] >= 0 and line["inference_time_s"] > 0


def test_multihost_env_group(corpus, tmp_path):
    """--multihost: two processes of an env:// group on localhost train
    dp as the launched dp run on 2 ranks does."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    base = argv(corpus) + ["--partition", "dp", "--epochs", "1"]
    procs = []
    for rank in range(2):
        env = dict(os.environ, MASTER_ADDR="localhost",
                   MASTER_PORT=str(port), RANK=str(rank), WORLD_SIZE="2",
                   OMP_NUM_THREADS="2")
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "graingraphnn_torch.cli.dist_train",
             *base, "--multihost", "--model_dir", str(tmp_path / "mh")],
            cwd=REPO, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = [p.communicate(timeout=240)[0] for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    launched = dist_train.main(base + ["--n_devices", "2", "--model_dir",
                                       str(tmp_path / "ln")])
    loss = [l for l in outs[0].splitlines() if l.startswith("Epoch:1")]
    assert loss == [f"Epoch:1, Train loss:{launched['train_loss'][0]:.6f}"]
    a = checkpoint.load(str(tmp_path / "mh" / "dist_regressor0"))[0]
    b = checkpoint.load(str(tmp_path / "ln" / "dist_regressor0"))[0]
    for k, v in checkpoint._flatten(a).items():
        np.testing.assert_array_equal(v.numpy(),
                                      checkpoint._flatten(b)[k].numpy())


def test_refusals(corpus):
    if not __import__("torch").cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            dist_train.main(["--dataset", f"{corpus}/train.pkl"])
    with pytest.raises(ValueError, match="does not divide"):
        dist_train.layout(dist_train.parse(
            argv(corpus) + ["--partition", "hybrid", "--gp", "3"]), 4)
    assert dist_train.layout(dist_train.parse(
        argv(corpus) + ["--partition", "halo", "--gp", "2"]), 4) == (
            2, (("gp", 2),))
    assert dist_train.layout(dist_train.parse(
        argv(corpus) + ["--partition", "hybrid"]), 4) == (
            4, (("dp", 2), ("gp", 2)))
