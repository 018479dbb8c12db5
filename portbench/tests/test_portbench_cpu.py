"""A measurement path with no card fails, and does not fall back: on this
machine the command exits non-zero and prints no result, and so it does in
a directory that holds only BENCHMARK.json and the benchmark's files."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import spec


def _run(cwd, seconds="1"):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "fp32-hex64x120", "--seed", "4294967301", "--seconds", seconds,
         "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=300, env={**os.environ, "CUDA_VISIBLE_DEVICES": ""})


def _no_result(proc):
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        with pytest.raises(ValueError):
            json.loads(line)


def test_no_card_no_result():
    if torch.cuda.is_available():
        pytest.skip("hidden by CUDA_VISIBLE_DEVICES, but a card is here")
    _no_result(_run(spec.ROOT))


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    _no_result(_run(tmp_path))
