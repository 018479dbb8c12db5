"""The cells' update kernel (csrc/cell_update.cu) against the torch
formulation it replaces (models.cells._gate_update), alone, on one card.

    python3 scripts/cell_update_compare.py [--turns 4] [--calls 20]

Shapes (joint rows / grain rows, C = 96): the benchmark's 64 lanes of
120 um (134016 / 67008), its 8 lanes of 240 um (66832 / 33416) and one
120 um lane (2086 / 1043). At each, one cell step on random messages and
states (c read, as every step of the forwards reads it) and a span's four
steps (two models, encoder and decoder). Each is timed by CUDA-graph replay of `--calls` calls between two CUDA
events, the least of `--turns` turns, kernel and torch formulation in
turns; beside it the byte bound (every message row, c and the bias read
once, h and c written once, at 3.35 TB/s) and the kernel's share of it.
The outputs are compared once per step: the largest distance in units in
the last place and whether they are equal bit for bit. Prints the card's
name and power limit, then one JSON line per shape.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from graingraphnn_torch.kernels import cell_update  # noqa: E402
from graingraphnn_torch.models import cells  # noqa: E402

PEAK_BYTES = 3.35e12     # H100 SXM HBM3, bytes/s (datasheet)
C = 96
SHAPES = {"hex64x120": (134016, 67008), "hex8x240": (66832, 33416),
          "lane120": (2086, 1043)}


def ulps(a, b):
    """The largest distance between a and b in units in the last place
    (fp32; +0 and -0 are one value)."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    if a.numel() == 0:
        return 0
    return int((ordered(a) - ordered(b)).abs().max())


def step_inputs(nj, ng, null_c, gen, dev):
    """(joint, grain) parts as cell_update.launch takes them: messages of
    a trained model's scale (gates mostly within +-4), biases, c (None,
    the zero state unread, where null_c)."""
    def r(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(dev)

    joint = ((r(nj, 4 * C, scale=1.5), r(nj, 4 * C, scale=1.5)),
             r(4, C, scale=0.3), None if null_c else r(nj, C))
    grain = ((r(ng, 4 * C, scale=2.0),), r(4, C, scale=0.3),
             None if null_c else r(ng, C))
    return joint, grain


def kernel(joint, grain):
    return cell_update.cell_update_cuda(joint, grain, C)


def formulation(joint, grain):
    return cells._gate_update(*joint, C), cells._gate_update(*grain, C)


def step_bytes(nj, ng):
    """Each message row, c and the two biases read once, h and c written
    once."""
    per_row = lambda m: 4 * (m * 4 * C + C + 2 * C)  # noqa: E731
    return nj * per_row(2) + ng * per_row(1) + 2 * 4 * 4 * C


def captured(fn, calls):
    """A CUDA graph of `calls` calls of fn, replayed once."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph


def replay_ms(graph, calls):
    """One replay of graph between two CUDA events, in ms a call."""
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / calls


def compare(name, nj, ng, calls, turns, dev):
    gen = torch.Generator().manual_seed(nj + ng)
    row = {"shape": name, "joint_rows": nj, "grain_rows": ng, "C": C}
    joint, grain = step_inputs(nj, ng, False, gen, dev)
    got, want = kernel(joint, grain), formulation(joint, grain)
    torch.cuda.synchronize()
    pairs = [(g, w) for part_g, part_w in zip(got, want)
             for g, w in zip(part_g, part_w)]
    graphs = (captured(lambda: kernel(joint, grain), calls),
              captured(lambda: formulation(joint, grain), calls))
    times = ([], [])
    for _ in range(turns):              # kernel and formulation in turns
        for g, t in zip(graphs, times):
            t.append(replay_ms(g, calls))
    k_ms, t_ms = min(times[0]), min(times[1])
    bound = step_bytes(nj, ng) / PEAK_BYTES * 1e3
    row["step"] = {
        "kernel_ms": round(k_ms, 5), "torch_ms": round(t_ms, 5),
        "bound_ms": round(bound, 5),
        "bound_pct": round(100 * bound / k_ms, 1),
        "max_ulps": max(ulps(g, w) for g, w in pairs),
        "bit_equal": all(torch.equal(g, w) for g, w in pairs)}
    # four steps a span: two models, encoder and decoder
    row["span"] = {"kernel_ms": round(4 * k_ms, 5),
                   "torch_ms": round(4 * t_ms, 5),
                   "bound_ms": round(4 * bound, 5),
                   "bound_pct": round(100 * bound / k_ms, 1)}
    return row


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--calls", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("cell_update_compare: no CUDA device", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output", flush=True)
    dev = torch.device("cuda")
    with torch.no_grad():
        for name, (nj, ng) in SHAPES.items():
            print(json.dumps(compare(name, nj, ng, args.calls, args.turns,
                                     dev)), flush=True)


if __name__ == "__main__":
    main()
