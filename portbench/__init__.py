"""The benchmark of the PyTorch and CUDA port (graingraphnn_torch) on one
NVIDIA H100: batched 20-span rollout builds of the shipped GrainGNN
regressor and classifier, timed back to back, with the output of the
timed path held against a plain reference (reference/).

Run from the root of a checkout:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

BENCHMARK.json at the root lists the cells (a configuration under
configs/ and a traffic mix under traffic/, by name) and the metrics (a
reader under metrics/ for each per-layer one). cost.py holds the frozen
FLOP and byte arithmetic and the chip's peaks; control.py reads the
numbers that the limits of the output check were set from.
"""
