"""Each cell on the card, briefly: the command's last line is a correct
result with every end-to-end metric, and with --trace 1 every per-layer
one. Needs an NVIDIA GPU (python -m pytest -m cuda portbench/tests)."""

import json
import subprocess
import sys

import pytest
import torch

from portbench import spec

CELLS = [w["name"] for w in spec.benchmark()["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(cell, trace):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    proc = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell,
         "--seed", "3000000019", "--seconds", "2", "--trace", str(trace)],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-4000:]
    result = json.loads(proc.stdout.splitlines()[-1])
    assert result["correct"], proc.stderr[-4000:]
    c = spec.cell(cell)
    want = c.per_layer if trace else c.end_to_end
    assert set(result["metrics"]) == {m["name"] for m in want}
    assert result["device"]["platform"] == "gpu"
