"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card

Phases: (1) the device, (2) building the CUDA sources in csrc/, (3) a
20-span device-resident rollout of the 120 um fixture graph with the
shipped checkpoints through all three kernels, with launch counts, peak
memory, throughput, and the editor kernel against its plain version and
timed on each span's own inputs, (4)
the fused PeriodConv edge stage against its plain version at the
rollout's three conv shapes (real masks, every 7th row masked, live
slots dropped at random), and each of its two kernels (node_proj,
edge_attn) alone against its own plain version, timed beside it, and the
cells' update kernel (csrc/cell_update.cu, one launch a cell step, 4 a
span wherever the kernels run on the card, none in a train step) within
one unit in the last place of its plain version at the decoder's cell
step, here and in (12), (5) the
topology-editor kernel against its plain version on the first span's
editor inputs and on forced scenarios, (6) a CPU reference span, (7) the
generate path through the port's driver (run_device_resident with
nucleation and the moving melt pool's whole sweep, counted like (3)), the
editor kernel against its plain version on each of its spans' windowed
inputs, one windowed, nucleating span against the CPU, and the port's CLI,
(8) the starting-graph generator on the host: its 120 um graph against the
committed fixture, bit for bit, and its generation and raster seconds at
40, 120 and 240 um, (9) the JAX package's generate recipe through the
port's CLI at 40 um (seed 3, G 4, R 1, the moving melt pool, the planar
reconstruction rasterised after every chunk), counted, with one span
against the CPU and the kernels at its shapes, (10) 10 spans of the
generated 240 um graph on the sort builder and on the persistent ELL
column tables (topology bit-equal, ms per span of each), one span against the
CPU, a profile, and the kernels at its shapes, (11) training at the
shipped configs' full width: cli.train on 36 synthetic 40 um windows (the
regressor, then the transfer classifier), train_scanned with G,R jitter,
one step on the card against the CPU, the eval forward's launches, and
the saved checkpoints run for one rollout span, (12) the batched rollout
(before training in the run): 8 lanes of the generated 120 um graph
(seeds 5-12) stacked and run 20 static spans with one forward of each
model and one editor launch a span for all lanes, counted and timed
beside the single-lane span, each lane against its single-lane run, one
span against the CPU, the packed path at 2 lanes against the stacked
one, the editor over 8 lanes against its plain version, and the kernels
at the packed shapes, (13) the host engine, the CLI's default rollout
(before training in the run): the JAX package's 40 um recipe through
the CLI without --device_resident, counted, with the host editor and
with --jit_editor (the editor kernel against its plain version on every
span's inputs), 20 spans of the generated 120 um graph with the 4-member
regressor ensemble (ms a span by stage, pull rings, peak memory, a
profile of 2 spans), one span of each editor (and of --jit_editor with
nucleation) against the CPU, and edge_attn at pull rings of 24 and 32
through the engine's forward, (14) the phase-field path (after
training in the run): a synthetic PF simulation built on the host (the
host engine's 20-span truth at the real fixture's recipe, 40 um, seed
10020, with other weights), its train-mode extraction through the array
entry with cli.merge and cli.train on the windows, and cli.test without
--generate, compare on, on the host engine, with --jit_editor and with
--device_resident, counted, with one span of each against the CPU and
the kernels at the PF graph's shapes, (15) the partitioned rollout (last
in the run): D ranks of parallel.mesh.launch on the one card over gloo
(NCCL takes a card per rank), each launching the kernels on its own
stripe: 20 spans of the 120 um fixture at D = 4, each span held to the
one-device span from the same state; 5 spans of the 240 um graph at
D = 8 on the column tables, trajectory-equal to the one-device run; 5
spans at D = 1 over NCCL; cli.test --partition 4 --device_resident on
the PF recipe; ms a span, editor retries, bytes exchanged a conv and
launches per rank, and the kernels at the stripes' shapes and at the
mini edit's, (16) distributed training (last in the run): 4 ranks
sharing the card on a (dp 2, gp 2) mesh run the partitioned forward of
both models on the 120 um fixture (row blocks, tables all-gathered;
12 + 12 launches a rank) against the one-device forward, one SGD(lr=1)
step of the partitioned, halo, hybrid and dp train steps against the
one-rank step, and cli.dist_train for each --partition (2 epochs, and 1
epoch resumed to 2); the dp step at D = 1 over NCCL; cli.dist_train
through its own launcher, its checkpoint through cli.test; and the
kernels at the gathered shapes, (17) the bf16 edge stage, JAX's
pallas=True rollout (after the reference span in the run): 20 spans of
the 120 um fixture on the bf16 kernels beside the fp32 run (launches by
precision, ms a span, device time, the event Jaccard of the two runs),
one bf16 span against the CPU's, 4 batched lanes against their
single-lane bf16 runs, node_proj_bf16 and edge_attn_bf16 against their
plain bf16 versions at the first span's decoder convs (and the fp32 conv,
which must fail the bf16 mean limit) with both library yardsticks and the
weight pack's one-time ms, cli.test --pallas and the kernels at the 40 um
graph's convs, and 2 counted bf16 spans of the 240 um graph and the
kernels at its convs; the bf16 kernels' ptxas lines first. The editor
phase (5) also holds the kernel's cleanup mask to its plain version.
Prints one JSON line per phase, the kernels line, and last {"ok": true,
"device": {...}}. Any failure exits non-zero.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import ctypes
import dataclasses
import hashlib
import io
import json
import math
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import warnings
from unittest import mock

import numpy as np
import torch

from graingraphnn_torch.cli import train as train_cli_mod
from graingraphnn_torch.graph import planar, schema, synthetic
from graingraphnn_torch.graph import state as gstate
from graingraphnn_torch.kernels import _build, cell_update, edge_stage, editor_fused
from graingraphnn_torch.models import cells, grain_nn
from graingraphnn_torch.ops import period_conv
from graingraphnn_torch.parallel import halo
from graingraphnn_torch.parallel import mesh as mesh_mod
from graingraphnn_torch.parallel import data_parallel, partition
from graingraphnn_torch.parallel import partitioned_rollout as pro
from graingraphnn_torch.rollout import device_driver as dd
from graingraphnn_torch.rollout import device_rollout as dr
from graingraphnn_torch.rollout import engine as engine_mod
from graingraphnn_torch.rollout import topology, topology_jit as tj
from graingraphnn_torch.train import checkpoint, trainer
from graingraphnn_torch.utils import profiling

N_SPANS = 20
C_THRESHOLD = 0.99
ATOL, RTOL = 1e-4, 1e-4       # fp32 kernel vs plain, sums reordered
EDITOR_ATOL = 1e-6
POS_ATOL = 1e-5               # positions, card span against the CPU span
# the generate path: nucleation (about one site per span) and the moving
# melt pool's whole sweep (r0 = 20, z0 = 4, 45 degrees: 86 spans at 120 um)
GEN = {"span": 6, "eval_every": 5, "nucleation_density": 2e-4,
       "meltpool": {"r0": 20.0, "z0": 4.0, "melt_pool_angle": math.pi / 4}}
# the generated workloads: the JAX package's generate recipe at 40 um (its
# CLI with the checkpoint's threshold), and 10 static spans at 240 um
GEN40 = ["--generate", "--device_resident", "--model_dir", "artifacts/40um",
         "--seed", "3", "--G", "4", "--R", "1", "--meltpool", "cylinder",
         "--r0", "20", "--z0", "4", "--eval_every", "5"]
GEN40_MELTPOOL = {"r0": 20.0, "z0": 4.0, "melt_pool_angle": math.pi / 4}
R240 = {"lxd": 240, "seed": 5, "G": 1.904, "R": 0.558, "spans": 10,
        "repeats": 3}
# the batched rollout: bench.py's 8 lanes of 120 um (seeds 5-12, G 1.904,
# R 0.558), 20 static spans; the packed path (pack_states, budgets x B)
# at the 2 lanes the editor kernel's per-lane limits allow, on the first
# two of those lanes (where the switch budget binds from the second span)
# and on the JAX package's own two 40 um test lanes (seeds 5, 7, G 4, R 1)
BATCHED = {"lxd": 120, "seeds": tuple(range(5, 13)), "G": 1.904,
           "R": 0.558, "spans": 20, "repeats": 5, "packed_lanes": 2,
           "packed_spans": 5, "packed40": {"seeds": (5, 7), "G": 4.0,
                                           "R": 1.0}}
# the host engine (the CLI's default rollout): the JAX package's 40 um
# recipe through the CLI without --device_resident (the checkpoint's
# threshold, 20 spans of the melt pool's sweep), the 120 um graph with
# the 4-member regressor ensemble for 20 spans, one span card against CPU
# at a threshold that switches (also nucleating), and edge_attn at the pull rings past 16
# that the engine sizes from the live degree (slots forced on 3 grains)
ENGINE40 = ["--generate", "--model_dir", "artifacts/40um", "--seed", "3",
            "--G", "4", "--R", "1", "--meltpool", "cylinder", "--r0", "20",
            "--z0", "4"]
ENGINE120 = {"lxd": 120, "seed": 5, "G": 1.904, "R": 0.558, "spans": 20}
ENSEMBLE_DIR = "artifacts/40um/ensemble"
ENGINE_SPAN = {"c_threshold": 0.9, "r_threshold": 3e-3, "seed": 11}
ENGINE_RINGS = {24: (18, 21, 24), 32: (18, 26, 30)}
# training: 36 synthetic windows of the 40 um patch's size (the shipped
# models were trained on 36 windows of one seed), 2 epochs per model, the
# card-vs-CPU step and the kernel rows at a packed batch of 8
TRAIN = {"samples": 36, "ng": 120, "epochs": 2, "eval_B": 8}
TRAIN_LOSS_RTOL = 1e-5
# the phase-field path: a synthetic PF simulation at the real fixture's
# recipe (40 um, seed 10020, G 1.904, R 0.558, span 6, 20 spans, 121
# frames) whose truth the host engine rolls with the 40um_jitter weights,
# so that the shipped 40um weights are scored against other dynamics;
# cli.train on its windows for 2 epochs, the compare runs in chunks of 5
PF = {"lxd": 40, "seed": 10020, "G": 1.904, "R": 0.558, "span": 6,
      "spans": 20, "frames": 121, "truth": "artifacts/40um_jitter",
      "epochs": 2, "eval_every": 5}
TRAIN_GRAD_ATOL, TRAIN_GRAD_RTOL = 1e-5, 1e-4
# the partitioned rollout: D ranks on the one card over gloo (NCCL takes a
# card per rank), each running the kernels on its own stripe. 20 spans of
# the 120 um fixture at D = 4, each held to the one-device span from the
# same state; 5 spans of the 240 um graph (rollout240's) at D = 8 on the
# column tables, trajectory-equal to the one-device run; 5 spans at D = 1
# over NCCL; cli.test --partition 4 --device_resident on the PF recipe
PART = {"D": 4, "spans": 20, "D240": 8, "spans240": 5, "wq240": 8192,
        "nccl_spans": 5, "cli_D": 4}
PART_POS_ATOL = 2e-5
# the training half of the parallel layer on 4 ranks sharing the card
# (gloo, staged) on a (dp 2, gp 2) mesh: the partitioned forward of both
# models on the 120 um fixture (row blocks, tables all-gathered) against
# the one-device forward; one SGD(lr=1) step of each distributed train
# step from the shipped weights against the one-rank step on the train
# phase's windows (partitioned and halo on one window, hybrid on 4, dp
# over the dp axis on 8), the dp step at D = 1 over NCCL (4 windows);
# cli.dist_train, each --partition for 2 epochs, and 1 epoch resumed to 2
DIST = {"D": 4, "axes": (("dp", 2), ("gp", 2)), "hybrid_batch": 4,
        "dp_batch": 8, "nccl_batch": 4, "epochs": 2, "halo_D": (4, 2),
        "partitions": ("dp", "hybrid", "halo")}
DIST_FWD_TOL = 2e-5           # atol and rtol, as JAX's tests/test_parallel.py
# a resumed run against the uninterrupted one, and two uninterrupted runs:
# bit-equal on the CPU, but on the card the backward's index_add (the
# gathers' transpose) sums with atomics in no fixed order (at most 1.1e-6
# on the H100). A resume that drops the optimizer's state is 6.5e-4 to
# 2.5e-2 off (the planted fault, read on the CPU and on the card); the
# limit lies between
DIST_RESUME_RTOL = 2e-5
# the bf16 kernels against their plain bf16 versions: the same roundings
# with fp32 sums in another order, so now and then the bf16 rounding of one
# logit product, relu value or alpha flips and moves a gate's row by about
# 2^-8 of a term. The mean is held tight, the max loose; the emulation of
# the sources read means up to 2.0e-6 of the scale and the fp32 conv
# against the plain bf16 version 8.1e-4 (the planted fault, which must
# read above the mean limit here too)
BF16_MEAN_REL, BF16_MAX_REL = 1e-5, 1e-2
# one bf16 span, card against CPU: positions' max and mean (the port's
# bf16 span against JAX's at 40 um read 1.3e-4 and 1.1e-7, its fp32 span
# 1.5e-2 and 2.0e-4)
BF16_POS_MAX, BF16_POS_MEAN = 1e-3, 1e-5
# the bf16 phase: JAX's pallas=True rollout (the bf16 edge stage) of the
# 120 um fixture beside the fp32 one, 20 spans; batched on 4 lanes of
# bench.py's 120 um seeds for 3 spans; 2 counted spans of the 240 um graph
# (the launches of its kernel rows)
BF16 = {"spans": 20, "repeats": 4, "lanes": 4, "lane_spans": 3,
        "spans240": 2}
# the H100 SXM's datasheet peaks, from utils.profiling
PEAK_FP32 = profiling.H100_PEAK_FP32
PEAK_TF32X3 = profiling.H100_PEAK_TF32X3
PEAK_BF16 = profiling.H100_PEAK_BF16
PEAK_BYTES = profiling.H100_PEAK_BYTES
REPLACES = {
    "push": "graingraphnn_tpu/kernels/edge_stage.py:58",
    "connect": "graingraphnn_tpu/kernels/edge_stage.py:58",
    "pull": "graingraphnn_tpu/kernels/edge_stage.py:156",
    "editor": "graingraphnn_tpu/kernels/editor_pallas.py:31",
    "cell_update": "graingraphnn_tpu/models/cells.py:75",
}


def emit(**kw):
    print(json.dumps(kw), flush=True)


def cuda_ms(fn, n=50, warmup=3):
    """Mean device time of fn() over n calls: the calls are captured into
    one CUDA graph and replayed between two CUDA events, so the host's time
    to issue them (the Python wrappers) is not counted."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    graph.replay()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output", flush=True)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    emit(phase="device", **dev, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda)
    return dev, smi


def phase_build():
    t0 = time.perf_counter()
    log = _build.build([(edge_stage.SOURCE, edge_stage.NVCC_FLAGS),
                        (edge_stage.SOURCE_BF16, edge_stage.NVCC_FLAGS),
                        (editor_fused.SOURCE, editor_fused.NVCC_FLAGS),
                        (cell_update.SOURCE, cell_update.NVCC_FLAGS)])
    emit(phase="build", seconds=time.perf_counter() - t0, sources=log)


def node_proj_cost(x_src, x_dst, GC, bf16=False):
    """(flops, bytes) of the four node projections: inputs and weights read
    once, the [N, 2 GC] outputs written once. With bf16, as the bf16 kernel
    takes them: the weights pre-packed at 2 bytes a value, and x_src's
    position lanes 0..2 left out of K and V (their weight rows are zero)."""
    (Ns, Fs), (Nd, Fd) = x_src.shape, x_dst.shape
    f0 = 3 if bf16 else 0
    flops = 2 * 2 * GC * (Ns * (Fs - f0) + Nd * Fd)
    bytes_ = (4 * (Ns * (Fs - f0) + Nd * Fd + 4 * GC + 2 * GC * (Ns + Nd))
              + (2 if bf16 else 4) * 2 * GC * (Fs - f0 + Fd))
    return flops, bytes_


def edge_attn_cost(x_src, x_dst, nbr_mask, G, C, bf16=False):
    """(tensor-core flops, fp32 flops, bytes) of the least work of the edge
    kernel on these inputs: the l2 product once per destination row with a
    live slot (the alpha-weighted sum moves inside the linear layer), the
    elementwise work per live edge; the projections, positions, tables and
    weights it needs read once (with bf16, Wl2 pre-packed at 2 bytes a
    value), the output written once."""
    Ns, Nd, GC = x_src.shape[0], x_dst.shape[0], G * C
    live = nbr_mask > 0
    rows = float(live.any(1).sum())
    K = nbr_mask.shape[1]
    bytes_ = (4 * (3 * Ns + 3 * Nd + 3 * Nd * K + 2 * Ns * GC + 2 * Nd * GC
                   + 6 * GC + 2 * GC + Nd * GC)
              + (2 if bf16 else 4) * G * C * C)
    return 2 * rows * G * C * C, float(live.sum()) * GC * 26, bytes_


def bound(bytes_, *work):
    """The least time in ms of moving bytes_ and of the operations in
    work = ((flops, peak rate), ...), summed, and which of the two is the
    larger."""
    t_ops = sum(flops / peak for flops, peak in work) * 1e3
    t_bytes = bytes_ / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def decoder_conv_inputs(reg, sample, precision="fp32"):
    """The decoder cell's conv inputs on the first span (h from the
    encoder at `precision`, as in the rollout): {name: (conv, x_src, x_dst,
    nbr, len, mask)}."""
    C = reg.hp.layer_size
    h, _c = cells.apply_pgclstm(reg.encoder[0], sample, sample.grain_x,
                                sample.joint_x, cells.zero_state(sample, C), C,
                                kernels=True, precision=precision)
    xg = torch.cat([sample.grain_x, h["grain"]], 1).contiguous()
    xj = torch.cat([sample.joint_x, h["joint"]], 1).contiguous()
    cv = reg.decoder[0].conv
    s = sample
    return {
        "push": (cv["push"], xg, xj, s.push_nbr, s.push_len, s.push_mask),
        "connect": (cv["connect"], xj, xj, s.connect_nbr, s.connect_len,
                    s.connect_mask),
        "pull": (cv["pull"], xj, xg, s.pull_nbr, s.pull_len, s.pull_mask),
    }


def ulps(a, b):
    """The largest distance between fp32 a and b in units in the last
    place (+0 and -0 are one value)."""
    def ordered(x):
        i = x.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int((ordered(a) - ordered(b)).abs().max()) if a.numel() else 0


def cell_update_row(reg, sample, launches, suffix="", workload="rollout"):
    """The cells' update kernel at the decoder's cell step of `sample` (its
    convs' messages, the encoder's c) against its plain version
    (cells._gate_update) on the card: within one unit in the last place,
    both timed, with its byte bound (every message row, c and the biases
    read once, h and c written once). launches: the counted run's."""
    C = reg.hp.layer_size
    h, c = cells.apply_pgclstm(reg.encoder[0], sample, sample.grain_x,
                               sample.joint_x, cells.zero_state(sample, C), C,
                               kernels=True)
    dec = reg.decoder[0]
    xg, xj = cells._gate_inputs(sample.grain_x, sample.joint_x, h)
    push, connect, pull = cells._period_convs(dec, sample, xg, xj,
                                              cells.NUM_GATES, C, True)
    joint = ((push, connect), dec.bias["joint"], c["joint"])
    grain = ((pull,), dec.bias["grain"], c["grain"])

    def kernel():
        return cell_update.cell_update_cuda(joint, grain, C)

    def plain():
        return cells._gate_update(*joint, C), cells._gate_update(*grain, C)

    pairs = [(g, w) for pg, pw in zip(kernel(), plain())
             for g, w in zip(pg, pw)]
    torch.cuda.synchronize()
    worst = max(ulps(g, w) for g, w in pairs)
    if worst > 1 or not all(bool(torch.isfinite(g).all()) for g, _ in pairs):
        raise RuntimeError(f"cell update{suffix}: {worst} ulp from its plain "
                           "version")
    NJ, NG = push.shape[0], pull.shape[0]
    bytes_ = 4 * (NJ * (2 * 4 * C + 3 * C) + NG * (4 * C + 3 * C) + 2 * 4 * C)
    bound_ms, bound_by = bound(bytes_)
    ms = cuda_ms(kernel)
    emit(phase="cell_update", workload=workload, joint_rows=NJ,
         grain_rows=NG, C=C, max_ulps=worst,
         bit_equal=all(torch.equal(g, w) for g, w in pairs), ms=ms,
         bound_ms=bound_ms, bound_pct=100 * bound_ms / ms, launches=launches)
    return dict(
        name=f"cell_update{suffix}", route="cuda",
        source="graingraphnn_torch/csrc/cell_update.cu",
        replaces=REPLACES["cell_update"],
        max_abs_err=max((g - w).abs().max().item() for g, w in pairs),
        ms=ms, plain_ms=cuda_ms(plain), bound_ms=bound_ms, bound_by=bound_by,
        library_ms=None, launches=launches,
        check=f"pass: within 1 ulp ({worst}) of the torch formulation")


def close(name, out, ref):
    """Max abs and relative error of out against ref; raises past
    ATOL + RTOL |ref| or on a non-finite value."""
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise RuntimeError(f"{name}: non-finite output")
    diff = (out - ref).abs()
    if bool((diff > ATOL + RTOL * ref.abs()).any()):
        raise RuntimeError(f"{name}: max abs err {diff.max().item()} over "
                           f"atol {ATOL} rtol {RTOL}")
    return (diff.max().item(),
            (diff / ref.abs().clamp_min(1e-3)).max().item())


def close_bf16(name, out, ref):
    """(max abs error, mean abs error over max |ref|) of a bf16 kernel's
    out against its plain bf16 version ref; raises past BF16_MEAN_REL or
    BF16_MAX_REL of max |ref|, or on a non-finite value."""
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        raise RuntimeError(f"{name}: non-finite output")
    err, scale = (out - ref).abs(), ref.abs().max().item()
    mean, mx = err.mean().item(), err.max().item()
    if mean > BF16_MEAN_REL * scale or mx > BF16_MAX_REL * scale:
        raise RuntimeError(f"{name}: mean abs err {mean / scale} and max "
                           f"{mx / scale} of the scale, over {BF16_MEAN_REL} "
                           f"and {BF16_MAX_REL}")
    return mx, mean / scale


def phase_edge_stage(reg, state):
    """The edge stage's kernels at the rollout's three conv shapes (the
    first span's decoder convs). Returns {(kernel, F_src, F_dst): row}."""
    sample, _ = dr.make_sample(state)
    return conv_kernel_rows(decoder_conv_inputs(reg, sample), reg.hp.layer_size)


def conv_kernel_rows(inputs, C, suffix="", workload="rollout"):
    """Per conv of inputs {name: (conv, x_src, x_dst, nbr, len, mask)}: the
    fused conv (both kernels, as the forwards call it) against its plain
    version, then each kernel alone against its own plain version, timed
    beside it. Returns {(kernel, F_src, F_dst): row} (row names end in
    suffix)."""
    G = cells.NUM_GATES
    GC = G * C
    kw = dict(num_gates=G, out_channels=C)
    rows = {}
    for name, (conv, xs, xd, nbr, ln, m) in inputs.items():
        K, Fs, Fd = nbr.shape[1], xs.shape[1], xd.shape[1]
        # the real masks, a copy with every 7th row fully masked, and one
        # with live slots dropped at random (not a prefix of the row)
        m_cut = m.clone()
        m_cut[::7] = 0.0
        gen = torch.Generator(device=m.device).manual_seed(K)
        m_scat = m * (torch.rand(m.shape, generator=gen,
                                 device=m.device) < 0.6)
        err = {"conv": 0.0, "node_proj": 0.0, "edge_attn": 0.0}
        rel = dict(err)
        for mask in (m, m_cut, m_scat):
            out = edge_stage.apply_period_conv_cuda(conv, xs, xd, nbr, ln,
                                                    mask, **kw)
            ref = period_conv.apply_period_conv_plain(conv, xs, xd, nbr, ln,
                                                      mask, **kw)
            e, r = close(f"edge stage {name}", out, ref)
            err["conv"], rel["conv"] = max(err["conv"], e), max(rel["conv"], r)
            proj_ref = period_conv.node_projections_plain(conv, xs, xd)
            for k, (o, pr) in enumerate(zip(
                    edge_stage.node_proj_cuda(conv, xs, xd), proj_ref)):
                e, r = close(f"node_proj {name} output {k}", o, pr)
                err["node_proj"] = max(err["node_proj"], e)
                rel["node_proj"] = max(rel["node_proj"], r)
            out = edge_stage.edge_attn_cuda(conv, xs, xd, nbr, ln, mask,
                                            proj_ref, **kw)
            ref = period_conv.edge_attn_plain(conv, xs, xd, nbr, ln, mask,
                                              proj_ref, **kw)
            e, r = close(f"edge_attn {name}", out, ref)
            err["edge_attn"] = max(err["edge_attn"], e)
            rel["edge_attn"] = max(rel["edge_attn"], r)
        proj = period_conv.node_projections_plain(conv, xs, xd)
        w_src = torch.cat([conv.key.w, conv.value.w], 1)
        b_src = torch.cat([conv.key.b, conv.value.b])
        w_dst = torch.cat([conv.query.w, conv.skip.w], 1)
        b_dst = torch.cat([conv.query.b, conv.skip.b])
        t = {
            "conv": cuda_ms(lambda: edge_stage.apply_period_conv_cuda(
                conv, xs, xd, nbr, ln, m, **kw)),
            "node_proj": cuda_ms(lambda: edge_stage.node_proj_cuda(
                conv, xs, xd)),
            "node_proj_plain": cuda_ms(
                lambda: period_conv.node_projections_plain(conv, xs, xd)),
            "node_proj_library": cuda_ms(lambda: (
                torch.addmm(b_src, xs, w_src), torch.addmm(b_dst, xd, w_dst))),
            "edge_attn": cuda_ms(lambda: edge_stage.edge_attn_cuda(
                conv, xs, xd, nbr, ln, m, proj, **kw)),
            "edge_attn_plain": cuda_ms(lambda: period_conv.edge_attn_plain(
                conv, xs, xd, nbr, ln, m, proj, **kw), n=20),
        }
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            edge_stage.apply_period_conv_cuda(conv, xs, xd, nbr, ln, m, **kw)
        conv_host_us = (time.perf_counter() - t0) * 1e4   # per call, issued
        torch.cuda.synchronize()
        np_flops, np_bytes = node_proj_cost(xs, xd, GC)
        np_bound, np_by = bound(np_bytes, (np_flops, PEAK_TF32X3))
        ea_tc, ea_fp32, ea_bytes = edge_attn_cost(xs, xd, m, G, C)
        ea_bound, ea_by = bound(ea_bytes, (ea_tc, PEAK_TF32X3),
                                (ea_fp32, PEAK_FP32))
        ea_flops = ea_tc + ea_fp32
        src = "graingraphnn_torch/csrc/edge_stage.cu"
        rows[("node_proj", Fs, Fd)] = dict(
            name=f"node_proj_{name}{suffix}", route="cuda", source=src,
            replaces=REPLACES[name], max_abs_err=err["node_proj"],
            ms=t["node_proj"], plain_ms=t["node_proj_plain"],
            bound_ms=np_bound, bound_by=np_by,
            library_ms=t["node_proj_library"],
            check=f"pass: atol {ATOL} rtol {RTOL}")
        rows[("edge_attn", Fs, Fd)] = dict(
            name=f"edge_attn_{name}{suffix}", route="cuda", source=src,
            replaces=REPLACES[name], max_abs_err=err["edge_attn"],
            ms=t["edge_attn"], plain_ms=t["edge_attn_plain"],
            bound_ms=ea_bound, bound_by=ea_by, library_ms=None,
            check=f"pass: atol {ATOL} rtol {RTOL}, also fully masked rows "
                  "and scattered live slots")
        emit(phase="edge_stage", workload=workload, conv=name, K=K,
             Ns=xs.shape[0],
             Nd=xd.shape[0], F_src=Fs, F_dst=Fd, live_edges=float(m.sum()),
             max_abs_err=err, max_rel_err=rel, atol=ATOL, rtol=RTOL,
             ms=t, conv_host_us=conv_host_us, node_proj_gflop=np_flops / 1e9,
             node_proj_mbytes=np_bytes / 1e6, node_proj_bound_ms=np_bound,
             node_proj_bound_fp32_ms=np_flops / PEAK_FP32 * 1e3,
             node_proj_tflops=np_flops / t["node_proj"] / 1e9,
             edge_attn_gflop=ea_flops / 1e9, edge_attn_mbytes=ea_bytes / 1e6,
             edge_attn_bound_ms=ea_bound,
             edge_attn_tflops=ea_flops / t["edge_attn"] / 1e9)
    return rows


def editor_inputs(reg, cls, state):
    """The first span's editor inputs, as edit_stage builds them."""
    sample, y_r, y_c, _ = dr.forward_stage(reg, cls, state, tj.RING_MAX)
    xg, xj = dr.integrate_stage(state, y_r["joint"], y_r["grain"], 6)
    ge, _ = dr.elim_candidates(state, y_r["grain_area"], 1e-4)
    logits = torch.where(state.E_pp[0] >= 0, y_c["edge_event"],
                         torch.full_like(y_c["edge_event"], dr.NEG))
    tstate = tj.TopoState(E_pp=state.E_pp, E_pq=state.E_pq, xj=xj,
                          y_joint=y_r["joint"], mask_g=state.mask_g,
                          mask_j=state.mask_j, append_ptr=state.n_pp)
    return tstate, logits, ge, y_r["grain"]


def forced_editor_inputs(tstate, seed, n_switch, n_elim):
    """Switches forced on random u<v edges and eliminations of the grains
    with the smallest rings (the JAX package's fused-editor test cases)."""
    rng = np.random.default_rng(seed)
    E = tstate.E_pp.cpu().numpy()
    Q = tstate.E_pq.cpu().numpy()
    logits = np.full(E.shape[1], dr.NEG, np.float32)
    logits[E[0] >= 0] = -50.0
    cand = np.nonzero((E[0] < E[1]) & (E[0] >= 0))[0]
    logits[cand[rng.choice(len(cand), n_switch, replace=False)]] = \
        rng.uniform(5.0, 15.0, n_switch)
    grains, counts = np.unique(Q[1][Q[1] >= 0], return_counts=True)
    small = grains[np.argsort(counts, kind="stable")][:12]
    ge = np.full(tj.MAX_ELIM, -1, np.int32)
    ge[:n_elim] = rng.choice(small, n_elim, replace=False)
    NG = tstate.mask_g.shape[0]
    y_grain = np.stack([rng.uniform(-0.5, 0.5, NG), np.zeros(NG)], 1)
    dev = tstate.E_pp.device
    return (tstate, torch.tensor(logits, device=dev),
            torch.tensor(ge, device=dev),
            torch.tensor(y_grain, dtype=torch.float32, device=dev))


def two_sided_inputs(tstate, seed=0, n_grains=3):
    """Editor inputs (state, logits, ge, y_grain, cg) on a copy of tstate
    in which n_grains grains are two-sided before the edit: each keeps two
    ring junctions joined by a jj edge, the rest of its E_pq columns
    killed, so the edit's final two-sided cleanup deletes it. The cleanup
    mask cg [NG] (bool) spares the first of them, so the masked edit
    differs from the unmasked one. Eight forced switches as well."""
    rng = np.random.default_rng(seed)
    E = tstate.E_pp.cpu().numpy()
    Q = tstate.E_pq.cpu().numpy().copy()
    NG = tstate.mask_g.shape[0]
    live = np.nonzero(tstate.mask_g.cpu().numpy() > 0)[0]
    chosen, used = [], set()
    for g in rng.permutation(live):
        cols = np.nonzero(Q[1] == g)[0]
        ring = set(Q[0][cols].tolist())
        if len(cols) < 4 or ring & used:
            continue
        pair = [c for c in np.nonzero(E[0] >= 0)[0]
                if E[0, c] in ring and E[1, c] in ring]
        if not pair:
            continue
        keep = (E[0, pair[0]], E[1, pair[0]])
        Q[:, cols[~np.isin(Q[0][cols], keep)]] = -1
        chosen.append(int(g))
        used |= ring
        if len(chosen) == n_grains:
            break
    dev = tstate.E_pp.device
    ts = dataclasses.replace(tstate, E_pq=torch.from_numpy(Q).to(dev))
    _, logits, ge, yg = forced_editor_inputs(ts, seed, 8, 0)
    cg = torch.ones(NG, dtype=torch.bool, device=dev)
    cg[chosen[0]] = False
    return ts, logits, ge, yg, cg


def clustered_switch_inputs(tstate, grains=range(0, 60, 7)):
    """Switches on every u<v jj edge touching the rings of a few grains, so
    later events share joints with earlier ones and the lookahead decides
    how each switch reconnects."""
    E, Q = tstate.E_pp.cpu(), tstate.E_pq.cpu()
    logits = torch.full((E.shape[1],), -50.0)
    logits[E[0] < 0] = dr.NEG
    p = 12.0
    for g in grains:
        ring = Q[0][Q[1] == g]
        hit = ((E[0] >= 0) & (E[0] < E[1]) & (logits < 0)
               & (torch.isin(E[0], ring) | torch.isin(E[1], ring)))
        cols = torch.nonzero(hit).flatten()
        logits[cols] = p - 0.1 * torch.arange(len(cols), dtype=torch.float32)
        p -= 0.1 * len(cols)
    dev, NG = tstate.E_pp.device, tstate.mask_g.shape[0]
    return (tstate, logits.to(dev),
            torch.full((tj.MAX_ELIM,), -1, dtype=torch.int32, device=dev),
            torch.zeros((NG, 2), device=dev))


def windowed_editor_inputs(state, seed, n_switch, n_elim, cut=0.5,
                           n_sites=4):
    """Editor inputs (state, logits, ge, y_grain, active_g) on a state with
    nucleation slack (state: a DeviceRolloutState with cursors): n_sites
    nucleations first, so some rings are the nuclei's triangles, then
    forced switches and eliminations under melt pool windows that are open
    where x < cut."""
    rng = np.random.default_rng(seed)
    dev, NJ = state.xj.device, state.xj.shape[0]
    live = torch.nonzero(state.mask_j > 0).flatten().cpu().numpy()
    rand = torch.ones(NJ, device=dev)
    rand[torch.from_numpy(rng.choice(live, n_sites, replace=False))] = 0.0
    angles = torch.from_numpy(
        rng.random((tj.MAX_NUC, 2)).astype(np.float32)).to(dev)
    ts = tj.TopoState(
        E_pp=state.E_pp, E_pq=state.E_pq, xj=state.xj,
        y_joint=torch.from_numpy(
            rng.uniform(-0.9, 0.9, (NJ, 2)).astype(np.float32)).to(dev),
        mask_g=state.mask_g, mask_j=state.mask_j, append_ptr=state.n_pp,
        q_ptr=state.n_pq)
    ts, xg, _, _, _ = tj.nucleate_jit(ts, state.xg, state.n_g, state.n_j,
                                      rand, angles, 0.5)
    ts = dataclasses.replace(ts, q_ptr=None, active_j=ts.xj[:, 0] < cut)
    _, logits, ge, yg = forced_editor_inputs(ts, seed, n_switch, n_elim)
    return ts, logits, ge, yg, xg[:, 0] < cut


def _to(ts, dev):
    return ts.map(lambda v: v.to(dev))


def forced_out_chain(tstate, max_grains=40):
    """Editor inputs [(state, logits, ge, y_grain)] on the CPU for a chain
    of edits that ends in a FORCED elimination: single switches shrink a
    small grain t to three sides, then a neighbour of t is eliminated with
    t's predicted darea lowest, so its ring collapse switches the edge
    shared with t first and forces t out (t lands in `extra`). Built with
    the plain editor; empty if no grain of the first `max_grains` allows
    it."""
    NG = tstate.mask_g.shape[0]

    def logits_for(st, cols):
        lg = torch.full((st.E_pp.shape[1],), dr.NEG)
        lg[st.E_pp[0] >= 0] = -50.0
        lg[cols] = 10.0
        return lg

    def ring(st, t):
        return set(st.E_pq[0][st.E_pq[1] == t].tolist())

    no_elim = torch.full((tj.MAX_ELIM,), -1, dtype=torch.int32)
    flat = torch.zeros((NG, 2))
    st0 = _to(tstate, "cpu")
    grains, counts = torch.unique(st0.E_pq[1][st0.E_pq[1] >= 0],
                                  return_counts=True)
    for t in grains[torch.argsort(counts, stable=True)][:max_grains].tolist():
        st, chain = st0, []
        while st is not None and len(ring(st, t)) > 3:
            r = ring(st, t)
            E = st.E_pp
            cols = [c for c in range(E.shape[1]) if int(E[0, c]) in r
                    and int(E[1, c]) in r and int(E[0, c]) < int(E[1, c])]
            nxt = None
            for c in cols:
                args = (st, logits_for(st, [c]), no_elim, flat)
                out = editor_fused.update_fused(*args, 0.6, NG)[0]
                if len(ring(out, t)) < len(ring(st, t)):
                    chain.append(args)
                    nxt = out
                    break
            st = nxt
        if st is None:
            continue
        nbrs = set(st.E_pq[1][torch.isin(st.E_pq[0], torch.tensor(
            sorted(ring(st, t)), dtype=st.E_pq.dtype)) & (st.E_pq[1] != t) & (st.E_pq[1] >= 0)]
            .tolist())
        yg = torch.zeros((NG, 2))
        yg[:, 0] = 0.3
        yg[t, 0] = -0.9
        for n in sorted(nbrs):
            ge = no_elim.clone()
            ge[0] = n
            args = (st, logits_for(st, []), ge, yg)
            extra = editor_fused.update_fused(*args, 0.6, NG)[2]
            if bool((extra == t).any()):
                return chain + [args]
    return []


def check_editor_case(ts, logits, ge, yg, thr, NG, active_g=None, cg=None):
    """The editor kernel against its plain version on CPU copies of the same
    inputs, probabilities, melt pool windows (ts.active_j, active_g) and
    cleanup mask cg: integer outputs bit-equal, floats within EDITOR_ATOL.
    Returns (plain outputs, float max abs err)."""
    prob = torch.sigmoid(logits)          # one tensor for both versions
    s_k, sw_k, ex_k = editor_fused.update_from_prob(
        ts, prob, ge, yg, thr, NG, active_g=active_g, cleanup_g_mask=cg)
    torch.cuda.synchronize()
    s_p, sw_p, ex_p = editor_fused.update_from_prob(
        _to(ts, "cpu"), prob.cpu(), ge.cpu(), yg.cpu(), thr, NG,
        active_g=None if active_g is None else active_g.cpu(),
        cleanup_g_mask=None if cg is None else cg.cpu())
    for f in ("E_pp", "E_pq", "mask_g", "mask_j", "append_ptr"):
        if not torch.equal(getattr(s_k, f).cpu(), getattr(s_p, f)):
            raise RuntimeError(f"editor: {f} differs from the plain version")
    if not (torch.equal(sw_k.cpu(), sw_p) and torch.equal(ex_k.cpu(), ex_p)):
        raise RuntimeError("editor: switching/extra differ from the plain "
                           "version")
    err = 0.0
    for f in ("xj", "y_joint"):
        d = (getattr(s_k, f).cpu() - getattr(s_p, f)).abs().max().item()
        if not d <= EDITOR_ATOL:
            raise RuntimeError(f"editor: {f} max abs err {d}")
        err = max(err, d)
    return (s_p, sw_p, ex_p), err


def editor_ms(args, NG, n=20):
    """Device time of one editor launch on args = (state, logits, ge,
    y_grain, threshold, active_g), from CUDA events."""
    ts, logits, ge, yg, thr, ag = args
    prob = torch.sigmoid(logits)
    return cuda_ms(lambda: editor_fused.update_from_prob(
        ts, prob, ge, yg, thr, NG, active_g=ag), n=n)


def check_captured(editor_args, NG):
    """Each captured span's editor inputs (state, logits, ge, y_grain,
    threshold, active_g): the kernel against its plain version, the
    kernel's device time and the plain version's time on the CPU. Returns
    (float max abs err, kernel ms per span, plain ms per span)."""
    err, span_ms, plain_ms = 0.0, [], []
    for args in editor_args:
        ts, logits, ge, yg, thr, ag = args
        _, e = check_editor_case(ts, logits, ge, yg, thr, NG, active_g=ag)
        err = max(err, e)
        span_ms.append(editor_ms(args, NG, n=5))
        cpu = (_to(ts, "cpu"), logits.cpu(), ge.cpu(), yg.cpu(), thr, NG)
        t0 = time.perf_counter()
        editor_fused.update_fused(
            *cpu, active_g=None if ag is None else ag.cpu())
        plain_ms.append((time.perf_counter() - t0) * 1e3)
    return err, span_ms, plain_ms


def phase_editor(reg, cls, state):
    """The kernel against the plain version on every case, and its device
    time on the first span's inputs."""
    dev = state.E_pp.device
    first = editor_inputs(reg, cls, state)
    cases = [("span1", first, C_THRESHOLD),
             ("forced_a", forced_editor_inputs(first[0], 0, 8, 2), 0.6),
             ("forced_b", forced_editor_inputs(first[0], 1, 24, 4), 0.6),
             ("clustered", clustered_switch_inputs(first[0]), 0.6)]
    chain = forced_out_chain(first[0])
    if not chain:
        raise RuntimeError("editor: no forced-elimination chain found")
    cases += [(f"forced_out_{i}", tuple(
        a.to(dev) if isinstance(a, torch.Tensor) else _to(a, dev)
        for a in args), 0.6) for i, args in enumerate(chain)]
    NG = state.xg.shape[0]
    err = 0.0
    for name, (ts, logits, ge, yg), thr in cases:
        (s_p, sw_p, ex_p), e = check_editor_case(ts, logits, ge, yg, thr, NG)
        err = max(err, e)
        emit(phase="editor", case=name, ints_equal=True, max_abs_err=e,
             switches=int((sw_p[:, 0] >= 0).sum()),
             grains_deleted=int((ts.mask_g.cpu() != s_p.mask_g).sum()),
             extra=int((ex_p >= 0).sum()))
    if not int((ex_p >= 0).sum()):
        raise RuntimeError("editor: the forced elimination did not happen")
    err = max(err, editor_cleanup_mask_cases(first[0], NG))
    args = (*first, C_THRESHOLD, None)
    ms = editor_ms(args, NG)
    ts, logits, ge, yg = first
    t0 = time.perf_counter()
    editor_fused.update_fused(_to(ts, "cpu"), logits.cpu(), ge.cpu(),
                              yg.cpu(), C_THRESHOLD, NG)
    plain_ms = (time.perf_counter() - t0) * 1e3
    emit(phase="editor_time", first_span_ms=ms, plain_cpu_ms=plain_ms)
    return dict(name="editor", route="cuda",
                source="graingraphnn_torch/csrc/editor.cu",
                replaces=REPLACES["editor"], max_abs_err=err,
                ms_first_span=ms, plain_ms_first_span=plain_ms,
                library_ms=None,
                check=f"pass: integers bit-equal, floats atol {EDITOR_ATOL}, "
                      f"{len(cases)} cases")


def editor_cleanup_mask_cases(tstate, NG):
    """The cleanup mask cg on the card: three grains made two-sided before
    the edit (two_sided_inputs), the mask sparing one; the kernel against
    its plain version with the mask, the spared grain alive and the
    others deleted, and a null mask giving the bits of a mask of all ones.
    Returns the float max abs err."""
    err = 0.0
    for seed in (0, 1):
        ts, logits, ge, yg, cg = two_sided_inputs(tstate, seed)
        (s_p, sw_p, ex_p), e = check_editor_case(ts, logits, ge, yg, 0.6, NG,
                                                 cg=cg)
        err = max(err, e)
        prob = torch.sigmoid(logits)
        null = editor_fused.update_from_prob(ts, prob, ge, yg, 0.6, NG)
        ones = editor_fused.update_from_prob(
            ts, prob, ge, yg, 0.6, NG, cleanup_g_mask=torch.ones_like(cg))
        same = all(torch.equal(a, b) for a, b in zip(
            (null[0].E_pp, null[0].E_pq, null[0].mask_g, null[0].xj,
             null[1], null[2]),
            (ones[0].E_pp, ones[0].E_pq, ones[0].mask_g, ones[0].xj,
             ones[1], ones[2])))
        spared = int(torch.nonzero(~cg)[0])
        deleted_null = int((ts.mask_g != null[0].mask_g).sum())
        deleted_mask = int((ts.mask_g.cpu() != s_p.mask_g).sum())
        if (not same or int(s_p.mask_g[spared]) != 1
                or int(null[0].mask_g[spared]) != 0
                or deleted_mask != deleted_null - 1):
            raise RuntimeError(
                f"editor cleanup mask: null == ones {same}, spared grain "
                f"{spared} kept {int(s_p.mask_g[spared])}, deleted "
                f"{deleted_mask} with the mask, {deleted_null} without")
        emit(phase="editor", case=f"cleanup_mask_{seed}", ints_equal=True,
             max_abs_err=e, switches=int((sw_p[:, 0] >= 0).sum()),
             grains_deleted=deleted_mask,
             grains_deleted_null_mask=deleted_null,
             null_equals_ones=same, extra=int((ex_p >= 0).sum()))
    return err


def editor_bound(args, cg=None):
    """The editor's state read once and written once, and the windows and
    the cleanup mask read where given; the work is a dependent chain, so
    this bound is far below its time."""
    ts, logits, ge, yg, _thr, ag = args
    nbytes = 4 * (2 * ts.E_pp.numel() + 2 * ts.E_pq.numel()
                  + 2 * ts.xj.numel() + 2 * ts.y_joint.numel()
                  + 2 * ts.mask_g.numel() + 2 * ts.mask_j.numel()
                  + logits.numel() + yg.shape[0] + ge.numel())
    if ag is not None:
        nbytes += 4 * (ts.mask_j.numel() + ts.mask_g.numel())
    if cg is not None:
        nbytes += 4 * cg.numel()
    return bound(nbytes)


def counted_launches():
    return {"node_proj": edge_stage.launches["node_proj"],
            "edge_attn": edge_stage.launches["edge_attn"],
            "by_shape": dict(edge_stage.shape_launches),
            "editor": editor_fused.launches,
            "cell_update": cell_update.launches}


def reset_launches():
    edge_stage.reset_counts()
    editor_fused.launches = 0
    cell_update.launches = 0


def phase_rollout(reg, cls, state, n_spans):
    """The counted main-path run, after a warm-up: every launch count set
    to 0 and the peak memory reset just before, both read just after. One
    more run, which must end where the counted one did, keeps the editor's
    inputs of each span (copied on the card as they pass); after it the
    kernel is held against its plain version on each and timed."""
    run = dr.make_rollout(reg, cls, n_steps=n_spans, c_threshold=C_THRESHOLD)
    run(state)                                   # warm-up
    torch.cuda.synchronize()
    reset_launches()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    final, aux = run(state)                      # the counted main-path run
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = counted_launches()
    with Recorder(capture=True) as cap:          # the captured run
        again, _ = run(state)
        torch.cuda.synchronize()
    if not all(torch.equal(getattr(final, f), getattr(again, f))
               for f in ("E_pp", "E_pq", "mask_g", "mask_j", "n_pp")):
        raise RuntimeError("rollout: the captured run differs from the "
                           "counted run")
    dts, enqueued = [], []
    for _ in range(4):
        # the host's part: its time inside the spans, which never wait for
        # the device (run() itself ends on a device-to-host read)
        with Recorder(capture=False) as rec:
            t0 = time.perf_counter()
            run(state)
            torch.cuda.synchronize()
            dts.append(time.perf_counter() - t0)
        enqueued.append(rec.enqueue_s)
    want = {"node_proj": 12 * n_spans, "edge_attn": 12 * n_spans,
            "editor": n_spans, "cell_update": 4 * n_spans}
    if any(launches[k] != v for k, v in want.items()):
        raise RuntimeError(f"launch counts {launches} for {n_spans} spans")
    for name in ("xg", "xj"):
        if not bool(torch.isfinite(getattr(final, name)).all()):
            raise RuntimeError(f"rollout: non-finite {name}")
    err, span_ms, plain_ms = check_captured(cap.editor, state.xg.shape[0])
    editor = dict(ms=sum(span_ms) / len(span_ms),
                  plain_ms=sum(plain_ms) / len(plain_ms), max_abs_err=err,
                  checked_spans=len(cap.editor),
                  bound=editor_bound(cap.editor[0]))
    edges = float(aux["message_edges"].sum())
    dt = min(dts)
    emit(phase="rollout", spans=n_spans, edges=edges, seconds=dts,
         enqueue_seconds=enqueued,
         edges_per_s=edges / dt, ms_per_span=dt / n_spans * 1e3,
         peak_mem_bytes=peak, resident_mem_bytes=resident, launches={
             k: ({str(kk): vv for kk, vv in v.items()} if k == "by_shape"
                 else v) for k, v in launches.items()},
         editor_span_ms=span_ms, editor_checked_spans=len(cap.editor),
         editor_max_abs_err=err,
         ring_overflow=int(aux["ring_overflow"].sum()),
         pp_overflow=int(aux["pp_overflow"].sum()),
         elim_saturated=int(aux["elim_saturated"].sum()),
         switches=int((aux["switching"][..., 0] >= 0).sum()),
         grain_events=int((aux["grain_events"] >= 0).sum()),
         live_grains=int(final.mask_g.sum()), live_joints=int(final.mask_j.sum()))
    return launches, editor


def phase_profile(reg, cls, state, n_spans, top=14):
    """Device time by kernel over one rollout under torch.profiler, and the
    device's busy share of that run's wall time (profiler on)."""
    run = dr.make_rollout(reg, cls, n_steps=n_spans, c_threshold=C_THRESHOLD)
    run(state)
    emit(phase="profile", spans=n_spans, **profile_run(run, state, top))


def phase_reference(reg, cls, state, reg_cpu, cls_cpu):
    """One span on the card against the same span through the plain
    versions on the CPU: forward outputs within tolerance, topology equal
    unless a switch probability lies within float noise of the threshold."""
    _, y_r, y_c, _ = dr.forward_stage(reg, cls, state, tj.RING_MAX)
    st_cpu = state.map(lambda v: v.cpu())
    _, y_r0, y_c0, _ = dr.forward_stage(reg_cpu, cls_cpu, st_cpu, tj.RING_MAX)
    err = max((y_r[k].cpu() - y_r0[k]).abs().max().item() for k in y_r)
    err = max(err, (y_c["edge_event"].cpu() - y_c0["edge_event"]).abs().max().item())
    if not err <= 1e-3:
        raise RuntimeError(f"reference span: forward max abs err {err}")
    s1, _ = dr.device_step(reg, cls, state, c_threshold=C_THRESHOLD)
    s0, _ = dr.device_step(reg_cpu, cls_cpu, st_cpu, c_threshold=C_THRESHOLD)
    p = torch.sigmoid(y_c0["edge_event"])
    near = bool(((p - C_THRESHOLD).abs() < 1e-5).any())
    same = all(torch.equal(getattr(s1, f).cpu(), getattr(s0, f))
               for f in ("E_pp", "E_pq", "mask_g", "mask_j", "n_pp"))
    if not same and not near:
        raise RuntimeError("reference span: topology differs from the CPU span")
    pos = (s1.xj[:, :2].cpu() - s0.xj[:, :2]).abs().max().item()
    emit(phase="reference_span", forward_max_abs_err=err, topology_equal=same,
         threshold_adjacent=near, position_max_abs_err=pos)


class Recorder:
    """Wraps module functions for one run and puts them back after. It
    always records the host's time inside the spans, their number and the
    last chunk's final state, which the driver holds anyway, so a counted
    run keeps no more on the card than it would alone. When capturing it
    also keeps each span's aux, each chunk's final state, the editor's
    inputs and the elimination candidates with and without the melt pool's
    window."""

    def __init__(self, capture: bool):
        self.capture = capture
        self.enqueue_s, self.spans, self.final = 0.0, 0, None
        self.auxs, self.states, self.editor, self.cand = [], [], [], [0, 0]
        self._saved = []

    def _wrap(self, mod, name, make):
        orig = getattr(mod, name)
        self._saved.append((mod, name, orig))
        setattr(mod, name, make(orig))

    def __enter__(self):
        def step(orig):
            def f(*a, **k):
                t0 = time.perf_counter()
                out = orig(*a, **k)
                self.enqueue_s += time.perf_counter() - t0
                self.spans += 1
                if self.capture:
                    self.auxs.append(out[1])
                return out
            return f

        def rollout(orig):
            def f(*a, **k):
                run = orig(*a, **k)

                def g(*ra, **rk):
                    out = run(*ra, **rk)
                    self.final = out[0]
                    if self.capture:
                        self.states.append(out[0])
                    return out
                return g
            return f

        def update(orig):
            def f(ts, logits, ge, yg, thr, NG, **k):
                ag = k.get("active_g")
                self.editor.append((ts.map(torch.clone), logits.clone(),
                                    ge.clone(), yg.clone(), thr,
                                    None if ag is None else ag.clone()))
                return orig(ts, logits, ge, yg, thr, NG, **k)
            return f

        def candidates(orig):
            def f(state, area, thr, max_elim=tj.MAX_ELIM, active_g=None):
                out = orig(state, area, thr, max_elim, active_g=active_g)
                self.cand[0] += int(orig(state, area, thr, max_elim)[1].sum())
                self.cand[1] += int(out[1].sum())
                return out
            return f

        self._wrap(dr, "device_step", step)
        self._wrap(dr, "batched_step", step)
        self._wrap(dr, "make_rollout", rollout)
        if self.capture:
            self._wrap(editor_fused, "update_fused", update)
            self._wrap(dr, "elim_candidates", candidates)
        return self

    def __exit__(self, *exc):
        for mod, name, orig in reversed(self._saved):
            setattr(mod, name, orig)


def gated_switches(ts, logits, thr):
    """Switch candidates (live u<v columns over the threshold) with an
    endpoint outside the melt pool's joint window."""
    E, aj = ts.E_pp, ts.active_j
    cand = (torch.sigmoid(logits) > thr) & (E[0] >= 0) & (E[0] < E[1])
    ends = aj[E[0].clamp_min(0).long()] & aj[E[1].clamp_min(0).long()]
    return int((cand & ~ends).sum())


def phase_generate(reg, cls, reg_cpu, cls_cpu, dev):
    """The generate path through the port's own driver: run_device_resident
    with nucleation and the moving melt pool's whole sweep over the 120 um
    fixture (counts, peak memory, host time), a second run that keeps every
    span's editor inputs for the kernel-vs-plain check, one windowed,
    nucleating span on the card against the CPU, and the CLI's JSON line.
    Returns the kernels line's editor row at this path's shape."""
    traj = dd.load_trajectory()
    # no raster (generate40 times it); each observation still rebuilds the
    # planar graph on the host, as JAX's does, and its seconds are reported
    kw = dict(span=GEN["span"], c_threshold=C_THRESHOLD,
              eval_every=GEN["eval_every"],
              nucleation_density=GEN["nucleation_density"], seed=traj.seed,
              meltpool=GEN["meltpool"], reconstruct=False, device=dev)
    state0, offset_j, factor = dd.init_scaled_state(
        traj.x, traj.edges, traj.mask, traj.lxd, traj.patch_size,
        nucleation_slack=dd.NUCLEATION_SLACK, device=dev)
    melt_term, gap = dd.make_melt_term(
        GEN["meltpool"], traj.lxd, GEN["span"], state0.xj.shape[0], offset_j,
        factor, dev)
    sweep = int(np.floor((1 - melt_term["win"]) / gap))
    chunks = -(-sweep // GEN["eval_every"])
    n_spans = chunks * GEN["eval_every"]       # the last chunk runs whole
    dd.run_device_resident(traj, reg, cls, **kw)        # warm-up
    torch.cuda.synchronize()
    reset_launches()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with Recorder(capture=False) as rec, PlanarTimer() as pt:  # counted
        res = dd.run_device_resident(traj, reg, cls, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if len(pt.rebuild) != chunks + 1 or pt.raster:
        raise RuntimeError(f"generate: {len(pt.rebuild)} rebuilds, "
                           f"{len(pt.raster)} rasters")
    rebuild_in_loop = sum(pt.rebuild[1:])       # frame 0's is before it
    peak = torch.cuda.max_memory_allocated()
    launches = {"node_proj": edge_stage.launches["node_proj"],
                "edge_attn": edge_stage.launches["edge_attn"],
                "editor": editor_fused.launches,
                "cell_update": cell_update.launches}
    want = {"node_proj": 12 * n_spans, "edge_attn": 12 * n_spans,
            "editor": n_spans, "cell_update": 4 * n_spans}
    if launches != want or rec.spans != n_spans:
        raise RuntimeError(f"generate: launch counts {launches}, "
                           f"{rec.spans} spans; want {want}")
    final = rec.final
    nucleated = int(final.n_g) - int(state0.n_g)
    for name in ("xg", "xj"):
        if not bool(torch.isfinite(getattr(final, name)).all()):
            raise RuntimeError(f"generate: non-finite {name}")
    if not np.isfinite(res["misorientation"]).all():
        raise RuntimeError("generate: non-finite misorientation")

    # the captured run keeps every span's aux and editor inputs; it must end
    # where the counted run did, so its aux stands for the counted run's
    with Recorder(capture=True) as cap:
        again = dd.run_device_resident(traj, reg, cls, **kw)
    if (again["events_pred"] != res["events_pred"]
            or again["misorientation"] != res["misorientation"]
            or not torch.equal(cap.final.E_pp, final.E_pp)):
        raise RuntimeError("generate: the captured run differs from the "
                           "counted run")
    aux = {k: torch.stack([a[k] for a in cap.auxs]) for k in cap.auxs[0]}
    flags = {f: int(aux[f].sum()) for f in
             ("ring_overflow", "pp_overflow", "nuc_overflow")}
    if any(flags.values()) or nucleated < 1:
        raise RuntimeError(f"generate: capacity flags {flags}, "
                           f"{nucleated} nucleations")
    err, span_ms, plain_ms = check_captured(cap.editor, state0.xg.shape[0])
    gated_sw = sum(gated_switches(ts, logits, thr)
                   for ts, logits, _, _, thr, _ in cap.editor)
    gated_cand = cap.cand[0] - cap.cand[1]
    if gated_sw + gated_cand < 1:
        raise RuntimeError("generate: the melt pool's window gated nothing")

    span = generate_reference_span(reg, cls, reg_cpu, cls_cpu,
                                   cap.states[4], melt_term, 25 * gap)
    cli = generate_cli("gpu" if dev.type == "cuda" else "cpu")
    emit(phase="generate", sweep_spans=sweep, spans=n_spans, chunks=chunks,
         eval_every=GEN["eval_every"], span=GEN["span"],
         nucleation_density=GEN["nucleation_density"],
         meltpool=GEN["meltpool"], win=melt_term["win"], gap=gap,
         seconds=wall, ms_per_span=wall / n_spans * 1e3,
         rebuild_s=pt.rebuild, rebuild_in_loop_s=rebuild_in_loop,
         ms_per_span_less_rebuild=(wall - sum(pt.rebuild)) / n_spans * 1e3,
         enqueue_seconds=rec.enqueue_s, driver_inference_s=res["inference_time"],
         peak_mem_bytes=peak, resident_mem_bytes=resident, launches=launches,
         capacity_flags=flags, nucleations=nucleated,
         gated_switches=gated_sw, gated_candidates=gated_cand,
         switches=int((aux["switching"][..., 0] >= 0).sum()),
         grain_events=int((aux["grain_events"] >= 0).sum()),
         events_pred=res["events_pred"],
         elim_saturated_steps=res["elim_saturated_steps"],
         num_grains_live=res["num_grains_live"],
         misorientation_last=res["misorientation"][-1],
         editor_checked_spans=len(cap.editor), editor_span_ms=span_ms,
         editor_max_abs_err=err, reference_span=span,
         cli=cli)
    st, logits, ge, yg, thr, ag = cap.editor[0]
    bound_ms, bound_by = editor_bound((st, logits, ge, yg, thr, ag))
    return dict(name="editor_generate", route="cuda",
                source="graingraphnn_torch/csrc/editor.cu",
                replaces=REPLACES["editor"], max_abs_err=err,
                ms=sum(span_ms) / len(span_ms),
                plain_ms=sum(plain_ms) / len(plain_ms), bound_ms=bound_ms,
                bound_by=bound_by, library_ms=None,
                launches=launches["editor"],
                check=f"pass: integers bit-equal, floats atol {EDITOR_ATOL}, "
                      f"{len(cap.editor)} windowed spans, nucleation slack "
                      f"{dd.NUCLEATION_SLACK}")


def generate_reference_span(reg, cls, reg_cpu, cls_cpu, state, melt_term,
                            melt_left):
    """One windowed span with two forced nucleation sites, on the card
    (where it must not wait for the device) and on the CPU from the same
    state: topology and cursors equal unless a switch probability lies
    within 1e-5 of the threshold, the nucleated rows equal."""
    rng = np.random.default_rng(1)
    NJ = state.xj.shape[0]
    live = torch.nonzero(state.mask_j > 0).flatten().cpu().numpy()
    rand = torch.ones(NJ)
    rand[torch.from_numpy(rng.choice(live, 2, replace=False))] = 0.0
    angles = torch.from_numpy(rng.random((tj.MAX_NUC, 2)).astype(np.float32))
    kw = dict(c_threshold=C_THRESHOLD, nuc_density_term=1.0)
    ml = torch.tensor(np.float32(melt_left))
    dev = state.xg.device
    card = dict(kw, nuc_rand=rand.to(dev), nuc_angles=angles.to(dev),
                melt_term=melt_term, melt_left=ml.to(dev))
    dr.device_step(reg, cls, state, **card)         # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")         # a host sync raises
    try:
        s1, a1 = dr.device_step(reg, cls, state, **card)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    st_cpu = state.map(lambda v: v.cpu())
    mt_cpu = dict(melt_term, offset_x=melt_term["offset_x"].cpu())
    s0, a0 = dr.device_step(reg_cpu, cls_cpu, st_cpu, **dict(
        kw, nuc_rand=rand, nuc_angles=angles, melt_term=mt_cpu, melt_left=ml))
    _, _, y_c0, _ = dr.forward_stage(reg_cpu, cls_cpu, st_cpu, tj.RING_MAX)
    p = torch.sigmoid(y_c0["edge_event"])
    near = bool(((p - C_THRESHOLD).abs() < 1e-5).any())
    ints = ("E_pp", "E_pq", "mask_g", "mask_j", "n_pp", "n_g", "n_j", "n_pq")
    same = all(torch.equal(getattr(s1, f).cpu(), getattr(s0, f)) for f in ints)
    if not same and not near:
        raise RuntimeError("generate span: topology differs from the CPU span")
    g0, g1 = int(state.n_g), int(s0.n_g)
    j0, j1 = int(state.n_j), int(s0.n_j)
    if g1 - g0 != 2 or int(s1.n_g) != g1 or int(s1.n_j) != j1:
        raise RuntimeError(f"generate span: nucleations {g1 - g0} on the "
                           f"CPU, cursors {int(s1.n_g)}/{int(s1.n_j)} on "
                           "the card")
    rows = max((s1.xg[g0:g1].cpu() - s0.xg[g0:g1]).abs().max().item(),
               (s1.xj[j0:j1].cpu() - s0.xj[j0:j1]).abs().max().item())
    if not rows <= POS_ATOL:
        raise RuntimeError(f"generate span: nucleated rows differ by {rows}")
    pos = (s1.xj[:, :2].cpu() - s0.xj[:, :2]).abs().max().item()
    calls = aten_calls(lambda: dr.device_step(reg, cls, state, **card))
    calls["static_span"] = aten_calls(lambda: dr.device_step(
        reg, cls, state, c_threshold=C_THRESHOLD))["span"]
    return dict(topology_equal=same, threshold_adjacent=near,
                nucleated_rows_max_abs_err=rows, position_max_abs_err=pos,
                melt_left=float(ml), no_host_sync=True,
                switches=int((a1["switching"][:, 0] >= 0).sum()),
                aten_calls=calls)


def aten_calls(fn):
    """The aten calls that fn() issues from the host: in all ("span") and
    inside the melt stage and the nucleation pass. On the card each costs
    the host about one launch or allocation."""
    from torch.utils._python_dispatch import TorchDispatchMode

    counts = {"span": 0, "melt_stage": 0, "nucleate_jit": 0}
    inside = []

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            counts["span"] += 1
            if inside:
                counts[inside[-1]] += 1
            return func(*args, **(kwargs or {}))

    def staged(name, orig):
        def f(*a, **k):
            inside.append(name)
            try:
                return orig(*a, **k)
            finally:
                inside.pop()
        return f

    with mock.patch.object(dr, "melt_stage",
                           staged("melt_stage", dr.melt_stage)), \
            mock.patch.object(tj, "nucleate_jit",
                              staged("nucleate_jit", tj.nucleate_jit)), \
            Count():
        fn()
    torch.cuda.synchronize()
    return counts


def generate_cli(platform):
    """The port's CLI on a short generate run (2 spans, nucleation on, the
    static melt pool), on the card: its JSON line."""
    from graingraphnn_torch.cli import test as cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(["--generate", "--device_resident", "--platform", platform,
                  "--model_dir", "artifacts/40um", "--lxd", "120",
                  "--seed", "5", "--G", "1.904", "--R", "0.558",
                  "--growth_height", "5.0", "--c_threshold", "0.99",
                  "--nucleation_density", str(GEN["nucleation_density"])])
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    keys = {"final_layer_error", "mean_layer_error", "events_tp",
            "events_truth", "events_pred", "KS", "inference_time_s"}
    if set(line) != keys:
        raise RuntimeError(f"cli: keys {sorted(line)}")
    return line


# ---------------------------------------------------------------------------
# the generated starting graphs
# ---------------------------------------------------------------------------


def same_trajectory(a, b):
    """The fields of two Trajectories that differ (arrays compared bit for
    bit, dtypes included)."""
    bad = []
    for part in ("x", "edges", "mask"):
        da, db = getattr(a, part), getattr(b, part)
        if da.keys() != db.keys():
            bad.append(part)
            continue
        bad += [f"{part}.{k}" for k in da if da[k].dtype != db[k].dtype
                or not np.array_equal(da[k], db[k])]
    if not np.array_equal(a.theta_z, b.theta_z):
        bad.append("theta_z")
    for k in ("area0", "lxd", "patch_size", "num_regions", "mesh_size",
              "ini_height", "final_height", "G", "R", "seed", "bc", "lyd",
              "imagesize"):
        if getattr(a, k) != getattr(b, k):
            bad.append(k)
    return bad


class PlanarTimer:
    """Host seconds inside PlanarGraph.rebuild_regions and rasterize, per
    call, for the duration of a with block."""

    def __init__(self):
        self.rebuild, self.raster = [], []

    def __enter__(self):
        def timed(orig, out):
            def f(*a, **k):
                t0 = time.perf_counter()
                try:
                    return orig(*a, **k)
                finally:
                    out.append(time.perf_counter() - t0)
            return f

        self._patches = [
            mock.patch.object(planar.PlanarGraph, "rebuild_regions",
                              timed(planar.PlanarGraph.rebuild_regions,
                                    self.rebuild)),
            mock.patch.object(planar.PlanarGraph, "rasterize",
                              timed(planar.PlanarGraph.rasterize,
                                    self.raster))]
        for p in self._patches:
            p.__enter__()
        return self

    def __exit__(self, *exc):
        for p in reversed(self._patches):
            p.__exit__(*exc)


def phase_generator():
    """The port's generator on this host: the 120 um graph against the
    committed fixture, bit for bit (numpy's legacy RandomState, LAPACK's
    SVD inside multivariate_normal and scipy's Qhull must give the JAX
    package's graph), and generation and raster seconds at 40, 120 and
    240 um. Returns {lxd: Trajectory}."""
    import scipy

    trajs, sizes = {}, []
    for lxd, seed, G, R in ((40, 3, 4.0, 1.0), (120, 5, 1.904, 0.558),
                            (R240["lxd"], R240["seed"], R240["G"],
                             R240["R"])):
        with PlanarTimer() as pt:
            t0 = time.perf_counter()
            trajs[lxd] = dd.generate_trajectory(lxd, seed, G, R)
            seconds = time.perf_counter() - t0
        t = trajs[lxd]
        sizes.append(dict(lxd=lxd, seed=seed, grains=t.num_regions,
                          junctions=len(t.x["joint"]),
                          pull_columns=int(t.edges["pull"].shape[1]),
                          raster_side=t.imagesize[0], seconds=seconds,
                          raster_seconds=pt.raster[0]))
    bad = same_trajectory(trajs[120], dd.load_trajectory())
    emit(phase="generator", numpy=np.__version__, scipy=scipy.__version__,
         fixture_equal=not bad, differing=bad, sizes=sizes)
    if bad:
        raise RuntimeError(f"generator: the 120 um graph differs from the "
                           f"fixture in {bad}")
    return trajs


def span_card_vs_cpu(reg, cls, reg_cpu, cls_cpu, state, **kw):
    """One span from the same state on the card and on the CPU: topology
    bit-equal unless a switch probability lies within 1e-5 of the
    threshold, positions within POS_ATOL."""
    st_cpu = state.map(lambda v: v.cpu())
    kw_cpu = dict(kw)
    if kw.get("melt_term") is not None:
        kw_cpu["melt_term"] = dict(
            kw["melt_term"], offset_x=kw["melt_term"]["offset_x"].cpu())
        kw_cpu["melt_left"] = kw["melt_left"].cpu()
    s1, a1 = dr.device_step(reg, cls, state, c_threshold=C_THRESHOLD, **kw)
    s0, a0 = dr.device_step(reg_cpu, cls_cpu, st_cpu, c_threshold=C_THRESHOLD,
                            **kw_cpu)
    _, _, y_c0, _ = dr.forward_stage(reg_cpu, cls_cpu, st_cpu, tj.RING_MAX)
    p = torch.sigmoid(y_c0["edge_event"])
    near = bool(((p - C_THRESHOLD).abs() < 1e-5).any())
    ints = ["E_pp", "E_pq", "mask_g", "mask_j", "n_pp"] + [
        f for f in ("pull_cols", "push_cols", "connect_cols")
        if getattr(state, f) is not None]
    same = all(torch.equal(getattr(s1, f).cpu(), getattr(s0, f))
               for f in ints)
    if not same and not near:
        raise RuntimeError("span: topology differs from the CPU span")
    pos = (s1.xj[:, :2].cpu() - s0.xj[:, :2]).abs().max().item()
    if not pos <= POS_ATOL:
        raise RuntimeError(f"span: positions differ by {pos}")
    return dict(topology_equal=same, threshold_adjacent=near,
                position_max_abs_err=pos, fields=ints,
                switches=int((a1["switching"][:, 0] >= 0).sum()),
                grain_events=int((a1["grain_events"] >= 0).sum()))


def editor_row(reg, cls, state, suffix, launches):
    """The editor kernel against its plain version on a state's first-span
    inputs and on forced switches and eliminations, timed on the first."""
    first = editor_inputs(reg, cls, state)
    NG = state.xg.shape[0]
    err = 0.0
    for (ts, logits, ge, yg), thr in (
            (first, C_THRESHOLD),
            (forced_editor_inputs(first[0], 0, 8, 2)[:4], 0.6),
            (forced_editor_inputs(first[0], 1, 24, 4)[:4], 0.6)):
        err = max(err, check_editor_case(ts, logits, ge, yg, thr, NG)[1])
    args = (*first, C_THRESHOLD, None)
    ms = editor_ms(args, NG)
    ts, logits, ge, yg = first
    t0 = time.perf_counter()
    editor_fused.update_fused(_to(ts, "cpu"), logits.cpu(), ge.cpu(),
                              yg.cpu(), C_THRESHOLD, NG)
    plain_ms = (time.perf_counter() - t0) * 1e3
    bound_ms, bound_by = editor_bound(args)
    return dict(name=f"editor{suffix}", route="cuda",
                source="graingraphnn_torch/csrc/editor.cu",
                replaces=REPLACES["editor"], max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, launches=launches,
                check=f"pass: integers bit-equal, floats atol {EDITOR_ATOL}, "
                      "first span and 2 forced cases")


def shape_rows(reg, cls, state, suffix, workload, launches):
    """The kernels line's rows at a state's shapes: node_proj and edge_attn
    of the three convs, and the editor."""
    sample, _ = dr.make_sample(state)
    rows = conv_kernel_rows(decoder_conv_inputs(reg, sample),
                            reg.hp.layer_size, suffix=suffix,
                            workload=workload)
    out = [dict(row, launches=launches["by_shape"].get(key, 0))
           for key, row in rows.items()]
    return out + [editor_row(reg, cls, state, suffix, launches["editor"])]


def phase_generate40(traj40, reg, cls, reg_cpu, cls_cpu, dev):
    """The JAX package's generate recipe through the port's CLI on the
    card: lxd 40, seed 3, G 4, R 1, the moving melt pool (r0 20, z0 4),
    the checkpoint's threshold, reconstruction on, 20 spans in 4 chunks.
    A warm-up run, then the counted one: launches, wall ms per span, the
    reconstruction's seconds, peak memory. Then one span from the run's
    final state against the CPU, and the kernels at this graph's shapes.
    Returns the kernels line's rows."""
    from graingraphnn_torch.cli import test as cli

    def run():
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(GEN40)
        return json.loads(out.getvalue().strip().splitlines()[-1])

    run()                                           # warm-up
    torch.cuda.synchronize()
    reset_launches()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with Recorder(capture=False) as rec, PlanarTimer() as pt:
        t0 = time.perf_counter()
        line = run()
        wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = counted_launches()
    n = rec.spans
    want = {"node_proj": 12 * n, "edge_attn": 12 * n, "editor": n,
            "cell_update": 4 * n}
    if n != 20 or any(launches[k] != v for k, v in want.items()):
        raise RuntimeError(f"generate40: {n} spans, launches {launches}")
    if set(line) != {"final_layer_error", "mean_layer_error", "events_tp",
                     "events_truth", "events_pred", "KS",
                     "inference_time_s"}:
        raise RuntimeError(f"generate40: CLI keys {sorted(line)}")
    final = rec.final
    for name in ("xg", "xj"):
        if not bool(torch.isfinite(getattr(final, name)).all()):
            raise RuntimeError(f"generate40: non-finite {name}")
    # the generator's raster, then the driver's: frame 0 before its timed
    # loop, and one after every chunk
    if len(pt.raster) != 6 or len(pt.rebuild) != 6:
        raise RuntimeError(f"generate40: {len(pt.raster)} rasters")
    in_loop = sum(pt.raster[2:]) + sum(pt.rebuild[2:])

    melt_term, gap = dd.make_melt_term(GEN40_MELTPOOL, traj40.lxd, 6,
                                       final.xj.shape[0],
                                       np.zeros((len(traj40.x["joint"]), 2)),
                                       1.0, dev)
    span = span_card_vs_cpu(
        reg, cls, reg_cpu, cls_cpu, final, melt_term=melt_term,
        melt_left=torch.tensor(np.float32(n * gap), device=dev))
    state, _, _ = dd.init_scaled_state(traj40.x, traj40.edges, traj40.mask,
                                       traj40.lxd, traj40.patch_size,
                                       device=dev)
    emit(phase="generate40", cli_args=GEN40, cli=line, spans=n,
         seconds=wall, inference_s=line["inference_time_s"],
         ms_per_span=line["inference_time_s"] / n * 1e3,
         enqueue_seconds=rec.enqueue_s,
         reconstruct_in_loop_s=in_loop, raster_s=pt.raster,
         rebuild_s=pt.rebuild,
         launches={k: ({str(kk): vv for kk, vv in v.items()}
                       if k == "by_shape" else v)
                   for k, v in launches.items()},
         peak_mem_bytes=peak, resident_mem_bytes=resident,
         grains=traj40.num_regions, junctions=len(traj40.x["joint"]),
         live_grains=int(final.mask_g.sum()), reference_span=span)
    return shape_rows(reg, cls, state, "_40um", "generate40", launches)


def timed_runs(run, states, repeats):
    """ms per span of run(state) for each state, alternating, `repeats`
    times each; and the host's time inside the spans."""
    ms = {k: [] for k in states}
    host = {k: [] for k in states}
    for _ in range(repeats):
        for k, st in states.items():
            torch.cuda.synchronize()
            with Recorder(capture=False) as rec:
                t0 = time.perf_counter()
                run(st)
                torch.cuda.synchronize()
                dt = time.perf_counter() - t0
            ms[k].append(dt / rec.spans * 1e3)
            host[k].append(rec.enqueue_s / rec.spans * 1e3)
    return ms, host


def profile_run(run, state, top=12):
    """Device time by kernel over run(state) under torch.profiler, and the
    device's busy share of the run's wall time (profiler on)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(state)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(ev.key, getattr(ev, "self_device_time_total", 0) / 1e3, ev.count)
            for ev in prof.key_averages()
            if str(ev.device_type).endswith("CUDA")]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    return {"wall_ms": wall, "device_ms": device_ms,
            "device_busy_share": device_ms / wall, "kernels": len(rows),
            "top": [{"name": k[:90], "ms": m, "count": c}
                    for k, m, c in rows[:top]]}


def phase_rollout240(traj, reg, cls, reg_cpu, cls_cpu, dev):
    """10 static spans of the generated 240 um graph: on the default ELL
    builder (the sort) counted, with the capacity flags checked and peak
    memory; the same spans on the persistent column tables (the JAX
    package's path at this size), topology bit-equal; ms per span of each
    (min of 3) with the host's time inside the spans; one span against
    the CPU; a profiled run; the kernels at this graph's shapes. Returns
    the kernels line's rows."""
    n = R240["spans"]
    args = (traj.x, traj.edges, traj.mask, traj.lxd, traj.patch_size)
    st_srt, _, factor = dd.init_scaled_state(*args, device=dev)
    st_inc, _, _ = dd.init_scaled_state(*args, incremental=True, device=dev)
    if st_inc.pull_cols is None or st_srt.pull_cols is not None:
        raise RuntimeError("rollout240: the wrong ELL builder was chosen")
    run = dr.make_rollout(reg, cls, n_steps=n, c_threshold=C_THRESHOLD)
    for st in (st_srt, st_inc):
        run(st)                                     # warm-up
    torch.cuda.synchronize()
    reset_launches()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fin_srt, aux = run(st_srt)                      # the counted run
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = counted_launches()
    want = {"node_proj": 12 * n, "edge_attn": 12 * n, "editor": n,
            "cell_update": 4 * n}
    if any(launches[k] != v for k, v in want.items()):
        raise RuntimeError(f"rollout240: launches {launches}")
    fin_inc, _ = run(st_inc)
    ints = ("E_pp", "E_pq", "mask_g", "mask_j", "n_pp")
    if not all(torch.equal(getattr(fin_inc, f), getattr(fin_srt, f))
               for f in ints):
        raise RuntimeError("rollout240: the column tables and the sort "
                           "builder end in different topologies")
    for name in ("xg", "xj"):
        if not bool(torch.isfinite(getattr(fin_srt, name)).all()):
            raise RuntimeError(f"rollout240: non-finite {name}")
    pos = max((getattr(fin_inc, f) - getattr(fin_srt, f)).abs().max().item()
              for f in ("xg", "xj"))
    ms, host = timed_runs(run, {"sort": st_srt, "columns": st_inc},
                          R240["repeats"])
    span = span_card_vs_cpu(reg, cls, reg_cpu, cls_cpu, st_srt)
    prof = profile_run(run, st_srt)
    edges = float(aux["message_edges"].sum())
    emit(phase="rollout240", lxd=traj.lxd, seed=traj.seed,
         grains=traj.num_regions, junctions=len(traj.x["joint"]),
         pull_columns=int(traj.edges["pull"].shape[1]),
         domain_factor=factor, spans=n,
         launches={k: ({str(kk): vv for kk, vv in v.items()}
                       if k == "by_shape" else v)
                   for k, v in launches.items()},
         capacity_flags={f: int(aux[f].sum()) for f in
                         ("ring_overflow", "pp_overflow", "nuc_overflow")},
         elim_saturated=int(aux["elim_saturated"].sum()),
         switches=int((aux["switching"][..., 0] >= 0).sum()),
         grain_events=int((aux["grain_events"] >= 0).sum()),
         topology_equal_columns=True, position_max_abs_diff_columns=pos,
         ms_per_span=ms, ms_per_span_min={k: min(v) for k, v in ms.items()},
         host_ms_per_span=host, edges=edges,
         edges_per_s=edges / (min(ms["sort"]) * n / 1e3),
         peak_mem_bytes=peak, resident_mem_bytes=resident,
         reference_span=span, profile=prof)
    return shape_rows(reg, cls, st_srt, "_240um", "rollout240", launches)


# ---------------------------------------------------------------------------
# the batched rollout
# ---------------------------------------------------------------------------

INTS = ("E_pp", "E_pq", "mask_g", "mask_j", "n_pp")


def stack_editor_lanes(cases):
    """Editor inputs of B lanes [(state, logits, ge, y_grain[, active_g])]
    as one lane-stacked (state, logits, ge, y_grain, active_g), padded to
    common sizes as stack_states pads a state: dead rows, -1 columns,
    logits at NEG, windows shut on the padding."""
    NG = max(c[0].mask_g.shape[0] for c in cases)
    NJ = max(c[0].mask_j.shape[0] for c in cases)
    EP = max(c[0].E_pp.shape[1] for c in cases)
    EQ = max(c[0].E_pq.shape[1] for c in cases)
    pad = dr._pad

    def lanes(fn):
        return torch.stack([fn(*c) for c in cases])

    def window(w, like, n):
        return pad(torch.ones_like(like, dtype=torch.bool) if w is None
                   else w, n, 0, False)

    ts = tj.TopoState(
        E_pp=lanes(lambda t, *_: pad(t.E_pp, EP, 1, -1)),
        E_pq=lanes(lambda t, *_: pad(t.E_pq, EQ, 1, -1)),
        xj=lanes(lambda t, *_: pad(t.xj, NJ, 0, 0.0)),
        y_joint=lanes(lambda t, *_: pad(t.y_joint, NJ, 0, 0.0)),
        mask_g=lanes(lambda t, *_: pad(t.mask_g, NG, 0, 0)),
        mask_j=lanes(lambda t, *_: pad(t.mask_j, NJ, 0, 0)),
        append_ptr=lanes(lambda t, *_: t.append_ptr.reshape(())),
        active_j=lanes(lambda t, *_: window(t.active_j, t.mask_j, NJ)))
    return (ts, lanes(lambda t, lg, *_: pad(lg, EP, 0, dr.NEG)),
            lanes(lambda t, lg, ge, *_: ge),
            lanes(lambda t, lg, ge, yg, *_: pad(yg, NG, 0, 0.0)),
            lanes(lambda t, lg, ge, yg, *ag: window(ag[0] if ag else None,
                                                    t.mask_g, NG)))


def lane_of(state, b, like):
    """Lane b of a stacked state cut to the single-lane state like's sizes,
    and whether the lane's padding past them is dead."""
    ng, nj = like.xg.shape[0], like.xj.shape[0]
    ep, eq = like.E_pp.shape[1], like.E_pq.shape[1]
    dead = not (bool(state.mask_g[b, ng:].any())
                or bool(state.mask_j[b, nj:].any())
                or bool((state.E_pp[b, :, ep:] >= 0).any())
                or bool((state.E_pq[b, :, eq:] >= 0).any()))
    return dr.DeviceRolloutState(
        xg=state.xg[b, :ng], xj=state.xj[b, :nj], E_pp=state.E_pp[b, :, :ep],
        E_pq=state.E_pq[b, :, :eq], mask_g=state.mask_g[b, :ng],
        mask_j=state.mask_j[b, :nj], n_pp=state.n_pp[b]), dead


def same_lane(state, b, single):
    """(lane b of a stacked state has single's topology and dead padding,
    the largest position difference between them)."""
    lane, dead = lane_of(state, b, single)
    same = dead and all(torch.equal(getattr(lane, f), getattr(single, f))
                        for f in INTS)
    pos = max((lane.xj[:, :2] - single.xj[:, :2]).abs().max().item(),
              (lane.xg[:, :2] - single.xg[:, :2]).abs().max().item())
    return same, pos


def near_threshold(logits, live):
    p = torch.sigmoid(logits)[live]
    return bool(((p - C_THRESHOLD).abs() < 1e-5).any())


def lanes_vs_singles(reg, cls, state, singles, n, pallas=False):
    """The batched run span by span beside each lane's single-lane run
    (forwards on the kernels `pallas` picks): a lane's topology must stay
    bit-equal to its single run's unless a switch probability of that
    lane's span lies within 1e-5 of the threshold, after which the lane
    is no longer compared. Returns the lanes still equal at the end, where
    each other lane parted, and the largest position difference of equal
    lanes."""
    st, sts, parted, pos = state, list(singles), {}, 0.0
    kw = dict(c_threshold=C_THRESHOLD, pallas=pallas)
    for i in range(n):
        near = [near_threshold(dr.forward_stage(
            reg, cls, s, tj.RING_MAX, dr._pallas_mode(pallas))[2]
            ["edge_event"], s.E_pp[0] >= 0) for s in sts]
        st, _ = dr.batched_step(reg, cls, st, **kw)
        sts = [dr.device_step(reg, cls, s, **kw)[0] for s in sts]
        for b, s in enumerate(sts):
            if b in parted:
                continue
            same, d = same_lane(st, b, s)
            if same:
                pos = max(pos, d)
            elif near[b]:
                parted[b] = i
            else:
                raise RuntimeError(f"batched: lane {b} differs from its "
                                   f"single-lane run at span {i}")
    return dict(spans=n, lanes_equal=len(sts) - len(parted),
                parted_at_threshold={str(b): i for b, i in parted.items()},
                position_max_abs_diff=pos)


def batched_span_card_vs_cpu(reg, cls, reg_cpu, cls_cpu, state):
    """One batched span of a stacked state on the card and on the CPU:
    every lane's topology bit-equal unless a switch probability lies
    within 1e-5 of the threshold, positions within POS_ATOL."""
    st_cpu = state.map(lambda v: v.cpu())
    B = state.xg.shape[0]
    sample, _, _ = dr._pack_build_sample(st_cpu)
    near = near_threshold(cls_cpu(sample, kernels=True)["edge_event"],
                          (st_cpu.E_pp[:, 0] >= 0).reshape(-1))
    s1, a1 = dr.batched_step(reg, cls, state, c_threshold=C_THRESHOLD)
    s0, _ = dr.batched_step(reg_cpu, cls_cpu, st_cpu,
                            c_threshold=C_THRESHOLD)
    same = all(torch.equal(getattr(s1, f).cpu(), getattr(s0, f))
               for f in INTS)
    if not same and not near:
        raise RuntimeError("batched span: topology differs from the CPU span")
    pos = (s1.xj[..., :2].cpu() - s0.xj[..., :2]).abs().max().item()
    if not pos <= POS_ATOL:
        raise RuntimeError(f"batched span: positions differ by {pos}")
    return dict(lanes=B, topology_equal=same, threshold_adjacent=near,
                position_max_abs_err=pos,
                switches=int((a1["switching"][..., 0] >= 0).sum()),
                grain_events=int((a1["grain_events"] >= 0).sum()))


def packed_lane(p_state, b, singles):
    """Lane b of a pack_states state in its own ids: (mask_g, mask_j, live
    E_pp columns in order, E_pq, xj)."""
    g0 = sum(s.xg.shape[0] for s in singles[:b])
    j0 = sum(s.xj.shape[0] for s in singles[:b])
    q0 = sum(s.E_pq.shape[1] for s in singles[:b])
    ng, nj = singles[b].xg.shape[0], singles[b].xj.shape[0]
    eq = singles[b].E_pq.shape[1]
    in_lane = (p_state.E_pp[0] >= j0) & (p_state.E_pp[0] < j0 + nj)
    q = p_state.E_pq[:, q0:q0 + eq]
    off = torch.tensor([[j0], [g0]], dtype=q.dtype, device=q.device)
    return (p_state.mask_g[g0:g0 + ng], p_state.mask_j[j0:j0 + nj],
            p_state.E_pp[:, in_lane] - j0, torch.where(q >= 0, q - off, -1),
            p_state.xj[j0:j0 + nj])


def packed_vs_stacked(reg, cls, singles, n):
    """pack_states on the single-lane make_rollout's span with the budgets
    x B against stack_states on the batched span, span by span from their
    own states: each lane's rows, live jj edges in order and pull edges
    equal. The packed budgets are shared by the lanes, so a lane may part
    only in a span where a budget binds (some lane has more switch
    candidates than MAX_SWITCH or more elimination candidates than
    MAX_ELIM, and the packed run shares out the budget otherwise) or a
    switch probability lies within 1e-5 of the threshold; it is not
    compared after. Returns the spans each lane stayed equal
    and where and why the others parted."""
    B = len(singles)
    p_st, s_st = dr.pack_states(singles), dr.stack_states(singles)
    equal, parted, pos = [0] * B, {}, 0.0
    for i in range(n):
        p_st, _ = dr.device_step(reg, cls, p_st, c_threshold=C_THRESHOLD,
                                 max_elim=tj.MAX_ELIM * B,
                                 max_switch=tj.MAX_SWITCH * B)
        with Recorder(capture=True) as cap:
            s_st, s_aux = dr.batched_step(reg, cls, s_st,
                                          c_threshold=C_THRESHOLD)
        ts, lg = cap.editor[0][:2]
        E = ts.E_pp
        live = E[:, 0] >= 0
        n_sw = ((torch.sigmoid(lg) > C_THRESHOLD) & live
                & (E[:, 0] < E[:, 1])).sum(-1)
        for b in range(B):
            if b in parted:
                continue
            lane, _ = lane_of(s_st, b, singles[b])
            mg, mj, pp, pq, xj = packed_lane(p_st, b, singles)
            s_pp = s_st.E_pp[b]
            if (torch.equal(mg, lane.mask_g) and torch.equal(mj, lane.mask_j)
                    and torch.equal(pp, s_pp[:, s_pp[0] >= 0])
                    and torch.equal(pq, lane.E_pq)):
                equal[b] += 1
                pos = max(pos, (xj[:, :2] - lane.xj[:, :2]).abs().max().item())
                continue
            why = [w for w, hit in (
                ("switch budget", bool((n_sw > tj.MAX_SWITCH).any())),
                ("elimination budget", bool(s_aux["elim_saturated"].any())),
                ("threshold", near_threshold(lg, live))) if hit]
            if not why:
                raise RuntimeError(f"packed: lane {b} differs from the "
                                   f"stacked run at span {i}")
            parted[b] = (i, why)
    return dict(lanes=B, spans=n, budgets=[tj.MAX_SWITCH * B,
                                           tj.MAX_ELIM * B],
                spans_equal=equal,
                parted={str(b): {"span": i, "why": w}
                        for b, (i, w) in parted.items()},
                position_max_abs_diff=pos)


def packed_refused(reg, cls, singles):
    """A packed state of len(singles) lanes needs budgets past the editor
    kernel's per-lane limits: its span must raise, with no fallback."""
    B = len(singles)
    try:
        dr.device_step(reg, cls, dr.pack_states(singles),
                       c_threshold=C_THRESHOLD, max_elim=tj.MAX_ELIM * B,
                       max_switch=tj.MAX_SWITCH * B)
    except ValueError as e:
        return str(e)
    raise RuntimeError(f"packed: a span of {B} packed lanes did not raise")


def batched_editor_row(reg, cls, state, suffix, launches):
    """The editor kernel over all lanes on the first batched span's inputs
    against its plain version (the lanes one by one on the CPU), timed
    beside one lane's launch alone."""
    with Recorder(capture=True) as cap:
        dr.make_rollout_batched(reg, cls, n_steps=1,
                                c_threshold=C_THRESHOLD)(state)
    args = cap.editor[0]
    ts, logits, ge, yg, thr, _ = args
    NG = ts.mask_g.shape[-1]
    (s_p, sw_p, _), err = check_editor_case(ts, logits, ge, yg, thr, NG)
    # and forced switches and eliminations in every lane
    forced = stack_editor_lanes([forced_editor_inputs(
        ts.map(lambda v: v[b]), b, 24, 4) for b in range(ts.E_pp.shape[0])])
    (f_p, _, _), f_err = check_editor_case(*forced[:4], 0.6, NG,
                                           active_g=forced[4])
    err = max(err, f_err)
    ms = editor_ms(args, NG)
    one_ms = editor_ms((ts.map(lambda v: v[0]), logits[0], ge[0], yg[0], thr,
                        None), NG)
    t0 = time.perf_counter()
    editor_fused.update_fused(_to(ts, "cpu"), logits.cpu(), ge.cpu(),
                              yg.cpu(), thr, NG)
    plain_ms = (time.perf_counter() - t0) * 1e3
    bound_ms, bound_by = editor_bound(args)
    return dict(name=f"editor{suffix}", route="cuda",
                source="graingraphnn_torch/csrc/editor.cu",
                replaces=REPLACES["editor"], max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, launches=launches, lanes=ts.E_pp.shape[0],
                one_lane_ms=one_ms,
                switches=int((sw_p[..., 0] >= 0).sum()),
                grains_deleted=int((ts.mask_g.cpu() != s_p.mask_g).sum()),
                forced_grains_deleted=int(
                    (forced[0].mask_g.cpu() != f_p.mask_g).sum()),
                check=f"pass: integers bit-equal, floats atol {EDITOR_ATOL}, "
                      "first batched span and forced switches and "
                      "eliminations in every lane, all lanes in one launch")


def phase_batched(reg, cls, reg_cpu, cls_cpu, dev, profile=False):
    """bench.py's batched rollout through the port: 8 lanes of the
    generated 120 um graph (seeds 5-12), patch-rescaled and stacked, 20
    static spans. The counted run (launches, capacity flags, peak memory),
    ms per span and edges/s (min of 5, the host's time inside the spans)
    beside the single-lane static span of seed 5, the aten calls of a
    span of each, no host sync, each lane span by span against its
    single-lane run, one batched span against the CPU, the packed path
    at 2 lanes against the stacked one (and its refusal at 8), the editor
    over all lanes against its plain version, and the kernels at the
    packed shapes. Returns the kernels line's rows."""
    cfg = BATCHED
    t0 = time.perf_counter()
    trajs = [dd.generate_trajectory(cfg["lxd"], seed, cfg["G"], cfg["R"])
             for seed in cfg["seeds"]]
    gen_s = time.perf_counter() - t0
    singles = [dd.init_scaled_state(t.x, t.edges, t.mask, t.lxd,
                                    t.patch_size, device=dev)[0]
               for t in trajs]
    state = dr.stack_states(singles)
    B, n = len(singles), cfg["spans"]
    suffix = f"_{B}x{cfg['lxd']}um"
    run = dr.make_rollout_batched(reg, cls, n_steps=n,
                                  c_threshold=C_THRESHOLD)
    run(state)                                      # warm-up
    torch.cuda.synchronize()
    reset_launches()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    final, aux = run(state)                         # the counted run
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = counted_launches()
    want = {"node_proj": 12 * n, "edge_attn": 12 * n, "editor": n,
            "cell_update": 4 * n}
    if any(launches[k] != v for k, v in want.items()):
        raise RuntimeError(f"batched: launches {launches}, want {want}")
    flags = {f: int(aux[f].sum()) for f in
             ("ring_overflow", "pp_overflow", "nuc_overflow")}
    if any(flags.values()):
        raise RuntimeError(f"batched: capacity flags {flags}")
    for name in ("xg", "xj"):
        if not bool(torch.isfinite(getattr(final, name)).all()):
            raise RuntimeError(f"batched: non-finite {name}")
    ms, host = timed_runs(run, {"batched": state}, cfg["repeats"])
    run1 = dr.make_rollout(reg, cls, n_steps=n, c_threshold=C_THRESHOLD)
    _, aux1 = run1(singles[0])
    ms1, host1 = timed_runs(run1, {"single": singles[0]}, cfg["repeats"])
    edges = float(aux["message_edges"].sum())
    edges1 = float(aux1["message_edges"].sum())
    calls = {"batched_span": aten_calls(lambda: dr.batched_step(
                 reg, cls, state, c_threshold=C_THRESHOLD))["span"],
             "single_static_span": aten_calls(lambda: dr.device_step(
                 reg, cls, singles[0], c_threshold=C_THRESHOLD))["span"]}
    if calls["batched_span"] > 2 * calls["single_static_span"]:
        raise RuntimeError(f"batched: aten calls {calls}")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")         # a host sync raises
    try:
        dr.batched_step(reg, cls, state, c_threshold=C_THRESHOLD)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    lanes = lanes_vs_singles(reg, cls, state, singles, n)
    span = batched_span_card_vs_cpu(reg, cls, reg_cpu, cls_cpu,
                                    dr.stack_states(singles[:2]))
    packed = {"120um": packed_vs_stacked(
        reg, cls, singles[:cfg["packed_lanes"]], cfg["packed_spans"])}
    p40 = cfg["packed40"]
    packed["40um"] = packed_vs_stacked(reg, cls, [dd.init_scaled_state(
        t.x, t.edges, t.mask, t.lxd, t.patch_size, device=dev)[0]
        for t in (dd.generate_trajectory(40, seed, p40["G"], p40["R"])
                  for seed in p40["seeds"])], cfg["packed_spans"])
    if min(packed["40um"]["spans_equal"]) < 1:
        raise RuntimeError(f"packed: no span compared at 40 um: {packed}")
    packed["refused_at_8"] = packed_refused(reg, cls, singles)
    editor = batched_editor_row(reg, cls, state, suffix, launches["editor"])
    prof = profile_run(run, state) if profile else None
    sample, _, _ = dr._pack_build_sample(state)
    rows = conv_kernel_rows(decoder_conv_inputs(reg, sample),
                            reg.hp.layer_size, suffix=suffix,
                            workload="batched")
    update = cell_update_row(reg, sample, launches["cell_update"], suffix,
                             "batched")
    emit(phase="batched", lanes=B, lxd=cfg["lxd"], seeds=cfg["seeds"],
         G=cfg["G"], R=cfg["R"], spans=n, generation_s=gen_s,
         grains=[int(s.mask_g.sum()) for s in singles],
         junctions=[int(s.mask_j.sum()) for s in singles],
         packed_rows={"grains": int(sample.grain_x.shape[0]),
                      "junctions": int(sample.joint_x.shape[0])},
         launches={k: ({str(kk): vv for kk, vv in v.items()}
                       if k == "by_shape" else v)
                   for k, v in launches.items()},
         capacity_flags=flags,
         elim_saturated=int(aux["elim_saturated"].sum()),
         switches=int((aux["switching"][..., 0] >= 0).sum()),
         grain_events=int((aux["grain_events"] >= 0).sum()),
         edges=edges, ms_per_span=ms["batched"],
         ms_per_span_min=min(ms["batched"]),
         host_ms_per_span=host["batched"],
         edges_per_s=edges / (min(ms["batched"]) * n / 1e3),
         single_lane={"edges": edges1, "ms_per_span": ms1["single"],
                      "host_ms_per_span": host1["single"],
                      "edges_per_s": edges1 / (min(ms1["single"]) * n / 1e3)},
         aten_calls=calls, no_host_sync=True,
         peak_mem_bytes=peak, resident_mem_bytes=resident,
         lanes_vs_singles=lanes, reference_span=span, packed=packed,
         editor={k: editor[k] for k in ("ms", "one_lane_ms", "plain_ms",
                                        "switches", "grains_deleted",
                                        "forced_grains_deleted")},
         profile=prof)
    return [dict(row, launches=launches["by_shape"].get(key, 0))
            for key, row in rows.items()] + [editor, update]


# ---------------------------------------------------------------------------
# the host engine
# ---------------------------------------------------------------------------


class EngineTimer:
    """Wraps the host engine's stages for the duration of a with block
    (class attributes, put back after): the spans, the pull ring of each
    span's sample, and ms a call of each stage: the sample built on the
    host, its copy to the card, the forwards (device time from CUDA events,
    and the host's time until they end), the predictions' copy back, the
    edit (the host editor, or the device one with its copies), the planar
    rebuild and the raster."""

    STAGES = ("sample", "h2d", "forward_device", "forward", "d2h", "edit",
              "rebuild", "raster")

    def __init__(self):
        self.ms = {k: [] for k in self.STAGES}
        self.rings = []

    def _timed(self, orig, key, sync=False):
        def f(*a, **k):
            t0 = time.perf_counter()
            out = orig(*a, **k)
            if sync:
                torch.cuda.synchronize()
            self.ms[key].append((time.perf_counter() - t0) * 1e3)
            return out
        return f

    def __enter__(self):
        E = engine_mod.RolloutEngine
        sample = self._timed(E._sample, "sample")

        def sample_ring(*a, **k):
            s = sample(*a, **k)
            self.rings.append(int(s.pull_nbr.shape[1]))
            return s

        def predict(*a, **k):
            e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            t0 = time.perf_counter()
            e0.record()
            out = E_predict(*a, **k)
            e1.record()
            torch.cuda.synchronize()
            self.ms["forward"].append((time.perf_counter() - t0) * 1e3)
            self.ms["forward_device"].append(e0.elapsed_time(e1))
            return out

        E_predict = E._predict
        self._patches = [
            mock.patch.object(E, "_sample", sample_ring),
            mock.patch.object(E, "_predict", predict),
            mock.patch.object(E, "_to_host", staticmethod(
                self._timed(E._to_host, "d2h"))),
            mock.patch.object(E, "_jit_update",
                              self._timed(E._jit_update, "edit", sync=True)),
            mock.patch.object(topology.TopologyEditor, "update", self._timed(
                topology.TopologyEditor.update, "edit")),
            mock.patch.object(gstate.GraphSample, "to", self._timed(
                gstate.GraphSample.to, "h2d", sync=True)),
            mock.patch.object(planar.PlanarGraph, "rebuild_regions",
                              self._timed(planar.PlanarGraph.rebuild_regions,
                                          "rebuild")),
            mock.patch.object(planar.PlanarGraph, "rasterize", self._timed(
                planar.PlanarGraph.rasterize, "raster")),
        ]
        for p in self._patches:
            p.__enter__()
        return self

    def __exit__(self, *exc):
        for p in reversed(self._patches):
            p.__exit__(*exc)

    @property
    def spans(self):
        return len(self.ms["forward"])

    def per_span(self, wall_s):
        """ms a span of each stage (summed over the run, over the spans),
        the rest of the wall time, and the wall time itself."""
        n = max(self.spans, 1)
        out = {k: sum(v) / n for k, v in self.ms.items()}
        staged = sum(v for k, v in out.items() if k != "forward_device")
        out["wall"] = wall_s * 1e3 / n
        out["other_host"] = out["wall"] - staged
        return out


def engine_cli(args):
    """The port's CLI without --device_resident (the host engine) on the
    card: its JSON line."""
    from graingraphnn_torch.cli import test as cli

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cli.main(args)
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    keys = {"final_layer_error", "mean_layer_error", "events_tp",
            "events_truth", "events_pred", "KS", "inference_time_s"}
    if set(line) != keys:
        raise RuntimeError(f"engine cli: keys {sorted(line)}")
    return line


def engine_launches_ok(launches, n_models, spans, editor):
    """The engine's counts: 6 node_proj and 6 edge_attn launches a model a
    span, 2 of the cells' update (encoder and decoder) and `editor` editor
    launches a span."""
    want = {"node_proj": 6 * n_models * spans,
            "edge_attn": 6 * n_models * spans, "editor": editor * spans,
            "cell_update": 2 * n_models * spans}
    if spans < 1 or any(launches[k] != v for k, v in want.items()):
        raise RuntimeError(f"engine: {spans} spans, launches {launches}, "
                           f"want {want}")


def jsonable(launches):
    return {k: ({str(kk): vv for kk, vv in v.items()}
                if isinstance(v, dict) else v) for k, v in launches.items()}


def engine_span_card_vs_cpu(jit_editor, density, dev, start=None,
                            compare=False):
    """One span of the host engine with the shipped checkpoints and
    nucleation density `density`, on the card and on the CPU from the same
    state: the 40 um recipe's graph, or start()'s (traj, hg0) with
    compare on. Topology bit-equal unless a switch probability lies within
    1e-5 of the threshold, positions within POS_ATOL, and with compare the
    layer errors equal under the same rule."""
    from graingraphnn_torch.data import extraction

    edits, logits, layer = {}, {}, {}
    for d in (dev, torch.device("cpu")):
        reg, _, _ = checkpoint.load_model("artifacts/40um/regressor0", d)
        cls, _, _ = checkpoint.load_model("artifacts/40um/classifier1", d)
        if start is None:
            traj = extraction.generate(40, 3, 4.0, 1.0)
            hg0 = extraction.make_test_sample(traj, span=6)
        else:
            traj, hg0 = start()
        eng = engine_mod.RolloutEngine(
            reg, cls, c_threshold=ENGINE_SPAN["c_threshold"],
            r_threshold=ENGINE_SPAN["r_threshold"], jit_editor=jit_editor,
            seed=ENGINE_SPAN["seed"], device=d)
        edit = eng._jit_update if jit_editor else eng.editor.update
        forward = eng._forward

        def keep_edit(*a, _edit=edit, _d=d.type, **k):
            out = _edit(*a, **k)
            edits[_d] = (out[1], out[2], out[3], copy.deepcopy(a[3]),
                         out[0]["joint"].copy())
            return out

        def keep_logits(*a, _d=d.type, **k):
            out = forward(*a, **k)
            logits[_d] = np.asarray(out[0][1]["edge_event"], np.float64)
            return out

        eng._forward = keep_logits
        if jit_editor:
            eng._jit_update = keep_edit
        else:
            eng.editor.update = keep_edit
        res = eng.run(hg0, traj, span=6, compare=compare, growth_height=2.6,
                      nucleation_density=density)
        layer[d.type] = res["layer_err_list"]
    p = 1.0 / (1.0 + np.exp(-logits["cpu"]))
    near = bool((np.abs(p - ENGINE_SPAN["c_threshold"]) < 1e-5).any())
    (e1, sw1, ex1, m1, xj1), (e0, sw0, ex0, m0, xj0) = (edits["cuda"],
                                                       edits["cpu"])
    same = (all(np.array_equal(e1[k], e0[k]) for k in e0)
            and all(np.array_equal(m1[k], m0[k]) for k in m0)
            and np.array_equal(sw1, sw0) and np.array_equal(ex1, ex0))
    if not same and not near:
        raise RuntimeError(f"engine span (jit_editor={jit_editor}): topology "
                           "differs from the CPU span")
    pos = float(np.abs(xj1[:, :2] - xj0[:, :2]).max()) if same else None
    if same and not pos <= POS_ATOL:
        raise RuntimeError(f"engine span: positions differ by {pos}")
    if layer["cuda"] != layer["cpu"] and not near:
        raise RuntimeError(f"engine span: layer errors {layer}")
    logit_err = float(np.abs(logits["cuda"] - logits["cpu"]).max())
    return dict(jit_editor=jit_editor, nucleation_density=density,
                grains=res["num_grains_final"], topology_equal=same,
                threshold_adjacent=near, position_max_abs_err=pos,
                logit_max_abs_err=logit_err, switches=int(len(sw0)),
                forced_elim=int(len(ex0)), compare=compare,
                layer_err_list=layer["cuda"] if compare else None,
                layer_err_equal=layer["cuda"] == layer["cpu"])


def engine_inputs(traj, hg0):
    """The engine's first-span forward inputs of a trajectory (x, edges,
    edge lengths), patch-rescaled as RolloutEngine.run rescales them."""
    x = {k: np.array(hg0.feature_dicts[k], np.float64)
         for k in ("grain", "joint")}
    edges = {k: np.array(hg0.edge_index_dicts[et], np.int64) for k, et in
             zip(("push", "pull", "connect"), schema.EDGE_TYPES)}
    edges["connect"] = edges["connect"][:, edges["connect"][0] > -1]
    attr = {et: np.array(v, np.float64)
            for et, v in hg0.edge_weight_dicts.items()}
    f = traj.lxd / traj.patch_size
    if f > 1:
        attr = {et: v * f for et, v in attr.items()}
        x["grain"][:, :2] *= f
        x["joint"][:, :2] *= f
        x["joint"][:, :2] -= np.floor(x["joint"][:, :2])
        x["grain"][:, :2] -= x["grain"][:, :2] - x["grain"][:, :2] % 1
    return x, edges, attr


def forced_rings(x, edges, attr, slots):
    """The inputs with pull edges added into the grains of the largest
    rings (from junctions outside each ring), so that they hold `slots`
    junctions each: a ring past 16, as eliminations merge rings."""
    pull_t = schema.EDGE_TYPES[1]
    pull, lens = edges["pull"], attr[pull_t]
    deg = np.bincount(pull[1])
    rng = np.random.default_rng(len(slots))
    add, add_len = [], []
    for g, n in zip(np.argsort(-deg, kind="stable"), slots):
        outside = np.setdiff1d(np.arange(len(x["joint"])), pull[0, pull[1] == g])
        js = rng.choice(outside, n - deg[g], replace=False)
        add.append(np.stack([js, np.full(len(js), g)]))
        add_len.append(rng.uniform(0.05, 0.3, (len(js), 1)))
    edges = dict(edges, pull=np.concatenate([pull] + add, axis=1))
    attr = dict(attr)
    attr[pull_t] = np.concatenate([lens] + add_len)
    return x, edges, attr


def engine_ring_rows(eng, traj, hg0, reg):
    """edge_attn at the pull rings past 16 through the engine's forward on
    the 120 um graph with forced rings (ENGINE_RINGS): the launches of the
    engine's forward at each ring, then the pull conv's kernels against
    their plain versions at that sample, timed. Returns the kernels line's
    edge_attn rows and the rings' launch counts."""
    x, edges, attr = engine_inputs(traj, hg0)
    ng, nj = len(x["grain"]), len(x["joint"])
    caps = (gstate.round_up(ng, 8), gstate.round_up(nj, 16),
            gstate.round_up(edges["connect"].shape[1], 32))
    eng._mask = {"grain": np.ones((ng, 1), np.int64),
                 "joint": np.ones((nj, 1), np.int64)}
    eng._bc = "periodic"
    rows, counts = [], {}
    for K, slots in ENGINE_RINGS.items():
        xs, es, at = forced_rings(x, edges, attr, slots)
        x32 = {k: v.astype(np.float32) for k, v in xs.items()}
        torch.cuda.synchronize()
        reset_launches()
        _, sample = eng._forward(x32, es, at, caps)   # the engine's path
        torch.cuda.synchronize()
        counts[K] = dict(edge_stage.ring_launches)
        if sample.pull_nbr.shape[1] != K or counts[K].get(K, 0) < 1:
            raise RuntimeError(f"engine ring {K}: sample ring "
                               f"{sample.pull_nbr.shape[1]}, {counts[K]}")
        inputs = decoder_conv_inputs(reg, sample)
        got = conv_kernel_rows({"pull": inputs["pull"]}, reg.hp.layer_size,
                               suffix=f"_engine_K{K}", workload="engine")
        row = next(r for key, r in got.items() if key[0] == "edge_attn")
        rows.append(dict(row, launches=counts[K][K], ring_slots=list(slots)))
    return rows, counts


def phase_engine(reg, cls, dev):
    """The host engine, the CLI's default rollout, on the card: (1) the
    JAX package's 40 um recipe through the CLI without --device_resident,
    counted, with the host editor and with --jit_editor, and the editor
    kernel against its plain version at the engine's shapes; (2) the 120
    um graph with the 4-member regressor ensemble, 20 spans counted, with
    the ms a span split by stage, the pull rings reached and peak memory;
    a profile of 2 of its spans; (3) one span on the card against the CPU
    with each editor; (4) edge_attn at pull rings of 24 and 32 through
    the engine's forward. Returns the kernels line's rows."""
    from graingraphnn_torch.data import extraction

    engine_cli(ENGINE40)                             # warm-up
    runs = {}
    for name, extra in (("host", []), ("jit_editor", ["--jit_editor"])):
        torch.cuda.synchronize()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        with EngineTimer() as et:
            t0 = time.perf_counter()
            line = engine_cli(ENGINE40 + extra)
            wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        launches = counted_launches()
        engine_launches_ok(launches, 2, et.spans, int(bool(extra)))
        runs[name] = dict(cli=line, inference_time_s=line["inference_time_s"],
                          spans=et.spans, seconds=wall,
                          ms_per_span=et.per_span(line["inference_time_s"]),
                          rings=sorted(set(et.rings)),
                          launches=jsonable(launches),
                          peak_mem_bytes=torch.cuda.max_memory_allocated())
        print(json.dumps(line), flush=True)
        emit(phase="engine40", editor=name, cli_args=ENGINE40 + extra,
             **runs[name])
    with Recorder(capture=True) as cap:              # the editor's inputs
        engine_cli(ENGINE40 + ["--jit_editor"])
    NG = cap.editor[0][0].mask_g.shape[0]
    err, span_ms, plain_ms = check_captured(cap.editor, NG)
    bound_ms, bound_by = editor_bound(cap.editor[0])
    editor_row = dict(
        name="editor_engine40", route="cuda",
        source="graingraphnn_torch/csrc/editor.cu",
        replaces=REPLACES["editor"], max_abs_err=err,
        ms=sum(span_ms) / len(span_ms), plain_ms=sum(plain_ms) / len(plain_ms),
        bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
        launches=runs["jit_editor"]["launches"]["editor"],
        widths={"E_pp": int(cap.editor[0][0].E_pp.shape[1]),
                "E_pq": int(cap.editor[0][0].E_pq.shape[1])},
        check=f"pass: integers bit-equal, floats atol {EDITOR_ATOL}, "
              f"{len(cap.editor)} engine spans (--jit_editor)")

    # (2) 120 um, the 4-member regressor ensemble
    cfg = ENGINE120
    traj = extraction.generate(cfg["lxd"], cfg["seed"], cfg["G"], cfg["R"])
    hg0 = extraction.make_test_sample(traj, span=6)
    paths = sorted(p[:-len(".ckpt")] for p in os.listdir(ENSEMBLE_DIR)
                   if p.endswith(".ckpt"))
    regs = [checkpoint.load_model(os.path.join(ENSEMBLE_DIR, p), dev)[0]
            for p in paths]
    if len(regs) != 4:
        raise RuntimeError(f"engine: ensemble of {len(regs)} regressors")

    def engine():
        return engine_mod.RolloutEngine(regs, cls, c_threshold=C_THRESHOLD,
                                        seed=cfg["seed"], device=dev)

    engine().run(hg0, traj, span=6, compare=False, growth_height=5.0)
    torch.cuda.synchronize()
    reset_launches()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with EngineTimer() as et:
        res = engine().run(hg0, traj, span=6, compare=False)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = counted_launches()
    launches["by_ring"] = dict(edge_stage.ring_launches)
    engine_launches_ok(launches, len(regs) + 1, et.spans, 0)
    if et.spans != cfg["spans"] or not np.isfinite(res["misorientation"]).all():
        raise RuntimeError(f"engine120: {et.spans} spans, misorientation "
                           f"{res['misorientation'][-3:]}")
    prof = profile_run(lambda _: engine().run(
        hg0, traj, span=6, compare=False, growth_height=5.0), None)
    spans = [engine_span_card_vs_cpu(jit, density, dev)
             for jit, density in ((False, 0.0), (True, 0.0), (True, 1e-2))]
    ring_rows, ring_counts = engine_ring_rows(engine(), traj, hg0, reg)
    emit(phase="engine120", lxd=cfg["lxd"], seed=cfg["seed"], G=cfg["G"],
         R=cfg["R"], ensemble=paths, spans=et.spans,
         grains=traj.num_regions, junctions=len(hg0.feature_dicts["joint"]),
         inference_s=res["inference_time"],
         ms_per_span=et.per_span(res["inference_time"]),
         ms_by_span={k: v for k, v in et.ms.items()},
         rings=et.rings, largest_ring=max(et.rings),
         launches=jsonable(launches),
         launches_per_span={k: launches[k] / et.spans
                            for k in ("node_proj", "edge_attn", "editor")},
         events_pred=res["events_pred"],
         live_grains=res["num_grains_live"], event_steps=res["event_steps"],
         peak_mem_bytes=peak, resident_mem_bytes=resident,
         profile_2_spans=prof, reference_spans=spans,
         forced_ring_launches={
             str(k): {str(kk): vv for kk, vv in v.items()}
             for k, v in ring_counts.items()})
    return ring_rows + [editor_row]


# ---------------------------------------------------------------------------
# the phase-field path: a synthetic PF simulation, extraction, cli.test
# ---------------------------------------------------------------------------


def pf_file_name(frames=PF["frames"]):
    """The synthetic PF file's name: the seed, G, Rmax and the last frame's
    index, in the layout load_pf_file parses."""
    return (f"synthetic_seed{PF['seed']}_G{PF['G']}_Rmax{PF['R']}"
            f"_frames{frames - 1}.h5")


def pf_truth(bc="periodic"):
    """The truth of the synthetic PF simulation: the host engine on the
    CPU in generate mode at PF's recipe (40 um, seed 10020, G 1.904,
    R 0.558, span 6, 20 spans) with the 40um_jitter weights and their
    threshold, each span's raster kept. Returns (rasters [x, y] for frame
    0 and each span, excess volumes [num_regions, spans + 1] in pixels^3,
    zero at frame 0, and the extractor it ran from)."""
    from graingraphnn_torch.data import extraction

    reg, _, _ = checkpoint.load_model(PF["truth"] + "/regressor0", "cpu")
    cls, _, extra = checkpoint.load_model(PF["truth"] + "/classifier1", "cpu")
    traj = extraction.generate(PF["lxd"], PF["seed"], PF["G"], PF["R"], bc=bc)
    hg0 = extraction.make_test_sample(traj, span=PF["span"])
    eng = engine_mod.RolloutEngine(reg, cls, c_threshold=extra["threshold"],
                                   seed=PF["seed"], device="cpu")
    s = traj.patch_size / traj.mesh_size + 1
    extraV = [np.zeros(traj.num_regions)]
    update = eng.editor.update

    def keep_extraV(x, edges, pred, mask, **kw):
        out = update(x, edges, pred, mask, **kw)
        xg = out[0]["grain"][: traj.num_regions]
        extraV.append(mask["grain"][: traj.num_regions, 0]
                      * xg[:, schema.GRAIN_EXTRAV_COL]
                      / schema.TARGET_SCALING["grain"] * s ** 3)
        return out

    eng.editor.update = keep_extraV
    # one thread: the 40 um forwards gain nothing from more, and parallel
    # test workers share the host's cores (the result is the same)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with torch.no_grad():
            res = eng.run(hg0, traj, span=PF["span"], compare=False,
                          collect_fields=True)
    finally:
        torch.set_num_threads(threads)
    rasters = res["alpha_field_list"]
    if len(rasters) != PF["spans"] + 1 or len(extraV) != PF["spans"] + 1:
        raise RuntimeError(f"pf truth: {len(rasters)} rasters")
    return rasters, np.stack(extraV, axis=1), traj


def fill_unpainted(a):
    """The raster with each unpainted pixel (id 0) given the largest id of
    its four neighbours, repeated until none is left."""
    a = a.copy()
    while (a == 0).any():
        near = np.max([np.roll(a, d, axis=k) for d in (1, -1)
                       for k in (0, 1)], axis=0)
        a = np.where(a == 0, near, a)
    return a


def junction_candidates(a, periodic, rng):
    """The PF junction candidates of one raster a[x, y]: every 2x2 window
    (over the wrap-padded raster where periodic) that holds at least 3
    distinct ids, as rows [x index, y index, max_nb, 5 labels padded with
    -1], the indices into the ghosted coordinate arrays."""
    b = np.pad(a, ((0, 1), (0, 1)), mode="wrap") if periodic else a
    w = np.stack([b[:-1, :-1], b[1:, :-1], b[:-1, 1:], b[1:, 1:]], axis=-1)
    w = np.sort(w, axis=-1)
    new = np.concatenate([np.ones(w.shape[:2] + (1,), bool),
                          w[..., 1:] != w[..., :-1]], axis=-1)
    ii, jj = np.nonzero(new.sum(-1) >= 3)
    labels = np.where(new[ii, jj], w[ii, jj], -1)
    labels = -np.sort(-labels, axis=-1)            # distinct ids first
    rows = np.full((len(ii), 8), -1, np.int64)
    rows[:, 0], rows[:, 1] = ii + 1, jj + 1
    rows[:, 2] = rng.integers(3, 100, len(ii))
    rows[:, 3:7] = labels
    return rows


def synthetic_pf_arrays(frames=PF["frames"], bc="periodic", truth=None):
    """A synthetic PF simulation in load_pf_file's layout, built from the
    host engine's truth rollout (pf_truth): (arrays by PF key, G, R,
    frames). Frame t holds the raster of span (t * 120 // (frames - 1))
    // 6 with unpainted pixels filled; cross_sec carries a one-pixel ghost
    border (wrapped, or repeated under no-flux), and x/y/z are um with a
    ghost point at each end (x[-2] = lxd). node_region holds each frame's
    junction candidates (junction_candidates, max_nb drawn from
    default_rng(seed)), padded to one node count with -1 labels.
    total_area is the truth's columnar pixel volume of each grain up to
    the frame's height (frame-0 area times ini_height / mesh + 1 layers,
    then the pixel areas integrated over the frames' heights) plus its
    excess volume; extra_area the excess volume the truth's regressor
    predicts (pixels^3, 0 at frame 0)."""
    rasters, extraV, traj = truth or pf_truth(bc)
    periodic = bc == "periodic"
    ratio = 120 // (frames - 1)
    which = [min(t * ratio // PF["span"], len(rasters) - 1)
             for t in range(frames)]
    spans = sorted(set(which))
    filled = {k: fill_unpainted(rasters[k]) for k in spans}
    rng = np.random.default_rng(PF["seed"])
    cands = {k: junction_candidates(filled[k], periodic, rng) for k in spans}
    nodes = max(len(c) for c in cands.values())
    node_region = np.full((8, nodes, frames), -1, np.int64)
    node_region[:3] = 0
    for t, k in enumerate(which):
        node_region[:, : len(cands[k]), t] = cands[k].T
    pad = "wrap" if periodic else "edge"
    ghosted = {k: np.pad(a, 1, mode=pad) for k, a in filled.items()}
    cross = np.stack([ghosted[k] for k in which], axis=-1)
    alpha = [filled[k] for k in which]

    ng = traj.num_regions
    area = np.stack([np.bincount(a.ravel(), minlength=ng + 1)[1: ng + 1]
                     for a in alpha], axis=1).astype(np.float64)
    dz = ratio * engine_mod.TRAIN_DELTA_Z / traj.mesh_size
    column = np.empty_like(area)
    column[:, 0] = area[:, 0] * (traj.ini_height / traj.mesh_size + 1)
    for t in range(1, frames):
        column[:, t] = column[:, t - 1] + dz * (area[:, t - 1] + area[:, t]) / 2
    extra = extraV[:, which]
    n0, n1 = cross.shape[:2]
    mesh = traj.mesh_size
    arrays = {
        "x_coordinates": (np.arange(n0) - 1) * mesh,
        "y_coordinates": (np.arange(n1) - 1) * mesh,
        "z_coordinates": (np.arange(frames + 2) - 1) * ratio
        * engine_mod.TRAIN_DELTA_Z + traj.ini_height,
        "cross_sec": cross.astype(np.int32).ravel(order="F"),
        "extra_area": extra.ravel(order="F"),
        "total_area": (column + extra).ravel(order="F"),
        "node_region": node_region.ravel(order="F"),
    }
    return arrays, PF["G"], PF["R"], frames


def write_pf_file(directory, pf):
    """pf = synthetic_pf_arrays(...) written with h5py as
    directory/pf_file_name(frames); returns its path."""
    import h5py

    arrays, _, _, frames = pf
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(str(directory), pf_file_name(frames))
    with h5py.File(path, "w") as f:
        for k, v in arrays.items():
            f.create_dataset(k, data=v)
    return path


@contextlib.contextmanager
def pf_source(pf, workdir):
    """The CLI's PF read served from memory: a placeholder file under the
    synthetic name in workdir (so the CLI's glob finds it), and
    TrajectoryExtractor.load_pf_file handing pf = (arrays, G, R, frames)
    to load_pf_arrays, as load_pf_file does with the arrays it reads.
    Yields the directory."""
    from graingraphnn_torch.data import extraction

    def load(self, rawdat_dir, cache_dir="./data_cache"):
        self.load_pf_arrays(*pf)

    d = os.path.join(workdir, "rawdat")
    os.makedirs(d, exist_ok=True)
    open(os.path.join(d, pf_file_name()), "wb").close()
    with mock.patch.object(extraction.TrajectoryExtractor, "load_pf_file",
                           load):
        yield d


def pf_start(pf):
    """The test-mode extraction of pf through the array entry and its t=0
    sample (window 6): (traj, hg0)."""
    from graingraphnn_torch.data import extraction

    traj = extraction.TrajectoryExtractor(lxd=PF["lxd"], seed=PF["seed"],
                                          frames=PF["frames"])
    traj.match_graph = False
    traj.load_pf_arrays(*pf)
    traj.extract_frames()
    return traj, extraction.make_test_sample(traj, span=PF["span"])


def pf_device_span_card_vs_cpu(ttraj, dev):
    """One span of the device-resident rollout with compare on, on the
    card and on the CPU from ttraj's first frame (the shipped checkpoints,
    ENGINE_SPAN's thresholds): the state after the span bit-equal on its
    integer fields and the layer errors equal, unless a switch probability
    lies within 1e-5 of the threshold; positions within POS_ATOL."""
    finals, probs, res = {}, {}, {}
    make, update = dr.make_rollout, editor_fused.update_fused
    for d in (dev, torch.device("cpu")):
        reg, _, _ = checkpoint.load_model("artifacts/40um/regressor0", d)
        cls, _, _ = checkpoint.load_model("artifacts/40um/classifier1", d)

        def factory(*a, _d=d.type, **k):
            run = make(*a, **k)

            def kept(st, *args, **kw):
                out = run(st, *args, **kw)
                finals[_d] = out[0]
                return out
            return kept

        def keep_probs(*a, _d=d.type, **k):
            probs.setdefault(_d, []).append(torch.sigmoid(a[1]).cpu())
            return update(*a, **k)

        with mock.patch.object(dr, "make_rollout", factory), \
                mock.patch.object(editor_fused, "update_fused", keep_probs):
            res[d.type] = dd.run_device_resident(
                ttraj, reg, cls, span=PF["span"],
                c_threshold=ENGINE_SPAN["c_threshold"],
                r_threshold=ENGINE_SPAN["r_threshold"], compare=True,
                growth_height=2.6, device=d)
    near = any(bool(((p - ENGINE_SPAN["c_threshold"]).abs() < 1e-5).any())
               for p in probs["cpu"])
    s1, s0 = finals["cuda"], finals["cpu"]
    ints = ["E_pp", "E_pq", "mask_g", "mask_j", "n_pp"]
    same = all(torch.equal(getattr(s1, f).cpu(), getattr(s0, f)) for f in ints)
    layer = {k: r["layer_err_list"] for k, r in res.items()}
    if (not same or layer["cuda"] != layer["cpu"]) and not near:
        raise RuntimeError(f"pf device span: topology equal {same}, layer "
                           f"errors {layer}")
    pos = (s1.xj[:, :2].cpu() - s0.xj[:, :2]).abs().max().item()
    if same and not pos <= POS_ATOL:
        raise RuntimeError(f"pf device span: positions differ by {pos}")
    return dict(mode="device_resident", topology_equal=same,
                threshold_adjacent=near, position_max_abs_err=pos,
                fields=ints, layer_err_list=layer["cuda"],
                layer_err_equal=layer["cuda"] == layer["cpu"],
                events_pred=res["cuda"]["events_pred"])


def phase_pf(reg, cls, dev, smi, workdir):
    """The phase-field path on the card: (1) the synthetic PF simulation
    built on the host (pf_truth on the CPU, synthetic_pf_arrays); (2) the
    train-mode extraction through the array entry (frames, quarantined
    frames, E1 switches, E2 eliminations, the calibrated span, the
    windows), written as cli.extract writes it, merged by cli.merge and
    trained on by cli.train (regressor0, B = 4, 2 epochs; ms a step from
    CUDA events, peak memory); (3) the test-mode extraction and the CLI
    without --generate, compare on, on the host engine, with --jit_editor
    and with --device_resident --eval_every 5, each counted (the CLI's
    JSON line, launches a span, peak memory); (4) one span of each mode
    with compare on the card against the CPU. Returns the kernels line's
    rows at the PF graph's shapes, launched by the device-resident run."""
    from graingraphnn_torch.cli import extract as extract_cli
    from graingraphnn_torch.cli import merge as merge_cli
    from graingraphnn_torch.data import extraction

    t0 = time.perf_counter()
    pf = synthetic_pf_arrays()
    build_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    traj = extraction.TrajectoryExtractor(lxd=PF["lxd"], seed=PF["seed"],
                                          frames=PF["frames"])
    traj.load_pf_arrays(*pf)
    traj.extract_frames()
    span = extraction.calibrate_span(traj)
    samples = extraction.make_training_samples(traj, span=span)
    train_extract_s = time.perf_counter() - t0
    extracted = dict(
        frames=len(traj.states), quarantined=traj.save_frame.count(False),
        quarantined_frames=[t for t, ok in enumerate(traj.save_frame)
                            if not ok],
        e1_switches=len(set.union(*traj.edge_events)) // 2,
        e2_eliminations=len(set.union(*traj.grain_events)),
        calibrated_span=span, windows=len(samples), seconds=train_extract_s)
    if not samples or extracted["quarantined"] == len(traj.states):
        raise RuntimeError(f"pf extraction: {extracted}")
    with contextlib.redirect_stdout(io.StringIO()):
        extract_cli.dump_states(samples, os.path.join(
            workdir, f"seed{PF['seed']}_span{span}_train.pkl"))
        merged = os.path.join(workdir, "pf_train.pkl")
        merge_cli.main(["--glob", os.path.join(workdir, "seed*_train.pkl"),
                        "--out", merged])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with StepTimer() as timer:
        log = train_cli(["--dataset", merged, "--epochs", str(PF["epochs"]),
                         "--model_dir", os.path.join(workdir, "pf_model"),
                         "--config", "artifacts/40um/regressor0.json"])
    ms = timer.ms()
    trained = dict(seconds=time.perf_counter() - t0, steps=len(ms),
                   batch=checkpoint.load_hp(
                       "artifacts/40um/regressor0").batch_size,
                   ms_per_step=sum(ms) / len(ms),
                   ms_per_step_after_first=sum(ms[1:]) / max(len(ms) - 1, 1),
                   step_ms=ms,
                   peak_mem_bytes=torch.cuda.max_memory_allocated(),
                   log_tail=log.strip().splitlines()[-2:])

    t0 = time.perf_counter()
    ttraj, hg0 = pf_start(pf)
    test_extract_s = time.perf_counter() - t0
    runs = {}
    with torch.no_grad(), pf_source(pf, workdir) as rawdat:
        base = ["--model_dir", "artifacts/40um", "--seed", str(PF["seed"]),
                "--rawdat_dir", rawdat]
        engine_cli(base)                              # warm-up
        for name, extra, editor in (
                ("host", [], 0), ("jit_editor", ["--jit_editor"], 1),
                ("device_resident", ["--device_resident", "--eval_every",
                                     str(PF["eval_every"])], 1)):
            torch.cuda.synchronize()
            reset_launches()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            line = engine_cli(base + extra)
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            launches = counted_launches()
            engine_launches_ok(launches, 2, PF["spans"], editor)
            if line["final_layer_error"] is None or line["KS"] is None:
                raise RuntimeError(f"pf {name}: no comparison: {line}")
            runs[name] = dict(
                cli=line, seconds=wall, launches=jsonable(launches),
                launches_per_span={k: launches[k] / PF["spans"] for k in
                                   ("node_proj", "edge_attn", "editor")},
                peak_mem_bytes=torch.cuda.max_memory_allocated())
            print(json.dumps(line), flush=True)
        device_launches = launches
        spans = [engine_span_card_vs_cpu(jit, 0.0, dev,
                                         start=lambda: pf_start(pf),
                                         compare=True)
                 for jit in (False, True)]
        start = dd.trajectory_from_extractor(ttraj, hg0)
        spans.append(pf_device_span_card_vs_cpu(start, dev))
        state, _, _ = dd.init_scaled_state(start.x, start.edges, start.mask,
                                           start.lxd, start.patch_size,
                                           device=dev)
        rows = shape_rows(reg, cls, state, "_pf", "pf", device_launches)
    emit(phase="pf", nvidia_smi=smi, lxd=PF["lxd"], seed=PF["seed"],
         G=PF["G"], R=PF["R"], truth_weights=PF["truth"],
         data_frames=PF["frames"], build_host_s=build_s,
         train_extraction=extracted, train=trained,
         test_extraction_s=test_extract_s, grains=ttraj.num_regions,
         junctions=len(hg0.feature_dicts["joint"]), cli_runs=runs,
         reference_spans=spans)
    return rows, pf, runs["device_resident"]["cli"]


# ---------------------------------------------------------------------------
# the partitioned rollout: D ranks of parallel.mesh.launch on the card
# ---------------------------------------------------------------------------


def same_topology(a, b):
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in INTS + ("pull_cols", "push_cols", "connect_cols")
               if getattr(a, f) is not None or getattr(b, f) is not None)


def state_digest(st):
    """sha256 of a rollout state's integer arrays, column tables and
    positions, bytes as they are."""
    h = hashlib.sha256()
    for f in INTS + ("pull_cols", "push_cols", "connect_cols", "xg", "xj"):
        v = getattr(st, f)
        if v is not None:
            h.update(f.encode())
            h.update(v.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def pos_diff(a, b):
    return max((getattr(a, f) - getattr(b, f)).abs().max().item()
               for f in ("xg", "xj"))


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def partition_rank(mesh, arrays, n_spans, check, incremental=False,
                   wq=1024):
    """One rank of the partition phase: the partitioned rollout of the
    host arrays (x, edges, mask, lxd, patch_size) with the shipped
    checkpoints, n_spans spans counted after a warm-up span: launches,
    bytes exchanged, ms a span and each span's state digest on this rank.
    Rank 0 then holds the run
    to the one-device rollout: check "span" steps the one-device span from
    each span's input state, "trajectory" runs the one-device rollout from
    the start; and keeps the first counted span's mini edit inputs
    (CPU copies) for the kernels line. The host's ms a span in the striped
    forward (its stripes' build apart) and in the sharded edits are read
    on each rank."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    reg = checkpoint.load_model("artifacts/40um/regressor0", dev)[0].eval()
    cls = checkpoint.load_model("artifacts/40um/classifier1", dev)[0].eval()
    st0, offset_j, factor = dd.init_scaled_state(
        *arrays, incremental=incremental, device=dev)

    def roll():
        return pro.PartitionedRollout(
            reg, cls, mesh, c_threshold=C_THRESHOLD, wq=wq, wp=wq,
            stripe_offsets=pro.stripe_offsets(arrays[0]["grain"], offset_j,
                                              factor))

    mini = []
    orig = editor_fused.update_fused

    def capture(ts, logits, ge, yg, thr, NG, **k):
        if not mini:
            mini.append((ts.map(lambda v: v.detach().cpu()), logits.cpu(),
                         ge.cpu(), yg.cpu(), float(thr),
                         k["cleanup_g_mask"].cpu()))
        return orig(ts, logits, ge, yg, thr, NG, **k)

    stage_ms = {"forward": 0.0, "stripes": 0.0, "edit": 0.0}

    def timed(stage, fn):
        def f(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            sync(dev)
            stage_ms[stage] += (time.perf_counter() - t0) * 1e3
            return out
        return f

    with torch.no_grad():
        roll().step(st0)                             # warm-up
        sync(dev)
        mesh.barrier()
        r = roll()
        r._forward = timed("forward", r._forward)
        halo.build_striped = timed("stripes", halo.build_striped)
        make_editor = r._editor
        r._editor = lambda *a: timed("edit", make_editor(*a))
        st, states, auxs, ms = st0, [st0], [], []
        reset_launches()
        mesh.bytes_exchanged = mesh.exchanges = 0
        for i in range(n_spans):
            editor_fused.update_fused = capture if i == 0 else orig
            try:
                t0 = time.perf_counter()
                st, aux = r.step(st)
                sync(dev)
                ms.append((time.perf_counter() - t0) * 1e3)
            finally:
                editor_fused.update_fused = orig
            states.append(st)
            auxs.append(aux)
        launches = counted_launches()
        out = dict(rank=mesh.rank, backend=mesh.backend,
                   transport=mesh.transport, ms_per_span=ms,
                   stage_ms_per_span={k: v / n_spans
                                      for k, v in stage_ms.items()},
                   launches=jsonable(launches),
                   by_shape=dict(launches["by_shape"]),
                   bytes_exchanged=mesh.bytes_exchanged,
                   exchanges=mesh.exchanges,
                   digests=[state_digest(s) for s in states[1:]],
                   editor_retries=[int(a["editor_retries"]) for a in auxs],
                   switches=sum(int((a["switching"][:, 0] >= 0).sum())
                                for a in auxs),
                   grain_events=sum(int((a["grain_events"] >= 0).sum())
                                    for a in auxs),
                   finite=all(bool(torch.isfinite(st.xj).all()
                                   & torch.isfinite(st.xg).all())
                              for st in states))
        if mesh.rank != 0:
            return out
        out["mini_edit"] = mini[0]
        if check == "span":
            same, pos, bit = [], [], []
            for s_in, s_out in zip(states, states[1:]):
                ref, _ = dr.device_step(reg, cls, s_in,
                                        c_threshold=C_THRESHOLD)
                same.append(same_topology(s_out, ref))
                pos.append(pos_diff(s_out, ref))
                bit.append(pos[-1] == 0.0)
        else:
            ref, aux_ref = dr.make_rollout(reg, cls, n_steps=n_spans,
                                           c_threshold=C_THRESHOLD)(st0)
            ev = all(np.array_equal(a["switching"],
                                    aux_ref["switching"][k].cpu().numpy())
                     and np.array_equal(a["grain_events"],
                                        aux_ref["grain_events"][k].cpu()
                                        .numpy())
                     for k, a in enumerate(auxs))
            same = [same_topology(st, ref) and ev]
            pos = [pos_diff(st, ref)]
            bit = [pos[0] == 0.0]
        out.update(topology_equal=same, position_max_abs_diff=pos,
                   positions_bit_equal=bit)
        return out


def pf_partition_rank(mesh, argv, npz):
    """One rank of cli.test --partition on the PF recipe: the CLI's rank
    body (its argument checks, PF extraction and run_device_resident with
    partition=D) with the PF read served from the arrays in npz (the card
    machine has no h5py), counted. Returns (result or None, launches,
    editor retries, the last span's state digest)."""
    from graingraphnn_torch.cli import test as test_cli
    from graingraphnn_torch.data import extraction

    with np.load(npz) as z:
        pf = ({k[2:]: z[k] for k in z.files if k.startswith("a_")},
              float(z["G"]), float(z["R"]), int(z["frames"]))

    def load(self, rawdat_dir, cache_dir="./data_cache"):
        self.load_pf_arrays(*pf)

    step, seen = pro.PartitionedRollout.step, {"retries": 0}

    def counted_step(self, st):
        st2, aux = step(self, st)
        seen["retries"] += aux["editor_retries"]
        seen["digest"] = state_digest(st2)
        return st2, aux

    torch.backends.cuda.matmul.allow_tf32 = False
    reset_launches()
    with torch.no_grad(), mock.patch.object(
            extraction.TrajectoryExtractor, "load_pf_file", load), \
            mock.patch.object(pro.PartitionedRollout, "step",
                              counted_step), \
            contextlib.redirect_stdout(io.StringIO()):
        res = test_cli._partition_rank(mesh, argv)
    return (res, jsonable(counted_launches()), seen["retries"],
            seen.get("digest"))


def check_partition_run(name, res, n_spans, D, backend):
    """D ranks on `backend`; every rank launched 12 node_proj and 12
    edge_attn a span and the editor once a span and once per retry, and
    left every span in the same state as rank 0 (equal digests), which
    rank 0 held to the one-device rollout."""
    if len(res) != D:
        raise RuntimeError(f"partition {name}: {len(res)} ranks, not {D}")
    for r in res:
        l, retries = r["launches"], sum(r["editor_retries"])
        if r["backend"] != backend:
            raise RuntimeError(f"partition {name}: rank {r['rank']} on "
                               f"{r['backend']}, not {backend}")
        if (l["node_proj"] != 12 * n_spans or l["edge_attn"] != 12 * n_spans
                or l["cell_update"] != 4 * n_spans
                or l["editor"] != n_spans + retries or not r["finite"]):
            raise RuntimeError(f"partition {name}: rank {r['rank']} "
                               f"launches {l}, retries {retries}")
        if r["digests"] != res[0]["digests"]:
            raise RuntimeError(f"partition {name}: rank {r['rank']}'s "
                               "states differ from rank 0's")
    top = res[0]
    if not all(top["topology_equal"]):
        raise RuntimeError(f"partition {name}: topology differs from the "
                           f"one-device rollout: {top['topology_equal']}")
    if not max(top["position_max_abs_diff"]) <= PART_POS_ATOL:
        raise RuntimeError(f"partition {name}: positions differ by "
                           f"{max(top['position_max_abs_diff'])}")


def partition_summary(res, n_spans):
    top = res[0]
    conv_apps = 12 * n_spans
    return dict(
        ranks=len(res), backend=top["backend"], transport=top["transport"],
        spans=n_spans, ms_per_span=top["ms_per_span"],
        ms_per_span_mean=sum(top["ms_per_span"]) / n_spans,
        stage_ms_per_span=top["stage_ms_per_span"],
        editor_retries=top["editor_retries"], switches=top["switches"],
        grain_events=top["grain_events"],
        bytes_exchanged_per_conv=top["bytes_exchanged"] / conv_apps,
        bytes_exchanged_per_exchange=top["bytes_exchanged"]
        / max(top["exchanges"], 1),
        launches_per_rank={r["rank"]: {k: r["launches"][k] for k in
                                       ("node_proj", "edge_attn", "editor")}
                           for r in res},
        topology_equal=top["topology_equal"],
        position_max_abs_diff=max(top["position_max_abs_diff"]),
        positions_bit_equal=top["positions_bit_equal"])


def stripe_conv_inputs(reg, cls, arrays, D, dev):
    """The decoder's conv inputs of stripe 0 of the D-stripe layout the
    partitioned rollout of the host arrays builds at span 0 (physical-x
    stripes, capacities pinned with its headroom): [left | local | right]
    source tables (Ns = 3 cap), local destination tables (Nd = cap), the
    ELL indices into the extended tables; h from the one-device encoder."""
    state, offset_j, factor = dd.init_scaled_state(*arrays, device=dev)
    r = pro.PartitionedRollout(
        reg, cls, mesh_mod.Mesh(D=D, rank=0, backend="gloo", device=dev),
        stripe_offsets=pro.stripe_offsets(arrays[0]["grain"], offset_j,
                                          factor))
    graph = r.host_graph(state)
    stripe_x = r._stripe_x(graph[0]["grain"], graph[0]["joint"])
    caps = r._stripe_caps(*graph, stripe_x)
    striped, meta = halo.build_striped(*graph, D, stripe_x=stripe_x, **caps)

    sample, _ = dr.make_sample(state)
    full = decoder_conv_inputs(reg, sample)

    def stripes(x, kind):
        cap = meta.grain_cap if kind == "grain" else meta.joint_cap
        out = torch.zeros((D * cap, x.shape[1]), device=dev)
        out[torch.from_numpy(meta.rows(kind)).to(dev)] = x
        return out.reshape(D, cap, -1)

    sg = stripes(full["push"][1], "grain")
    sj = stripes(full["connect"][1], "joint")

    def ext(t):
        return torch.cat([t[D - 1], t[0], t[1]]).contiguous()

    s0 = striped.map(lambda a: a[0].to(dev))
    cv = reg.decoder[0].conv
    return {
        "push": (cv["push"], ext(sg), sj[0].contiguous(), s0.push_nbr,
                 s0.push_len, s0.push_mask),
        "connect": (cv["connect"], ext(sj), sj[0].contiguous(),
                    s0.connect_nbr, s0.connect_len, s0.connect_mask),
        "pull": (cv["pull"], ext(sj), sg[0].contiguous(), s0.pull_nbr,
                 s0.pull_len, s0.pull_mask),
    }


def mini_editor_row(mini, launches):
    """The editor kernel at the mini edit's shape (the working set's W
    columns, the node arrays whole, the cleanup mask set) on a partitioned
    span's own inputs: against its plain version, timed, and its bound."""
    ts, logits, ge, yg, thr, cg = mini
    dev = torch.device("cuda")
    ts, logits, ge, yg, cg = (_to(ts, dev), logits.to(dev), ge.to(dev),
                              yg.to(dev), cg.to(dev))
    NG = ts.mask_g.shape[0]
    _, err = check_editor_case(ts, logits, ge, yg, thr, NG, cg=cg)
    prob = torch.sigmoid(logits)
    ms = cuda_ms(lambda: editor_fused.update_from_prob(
        ts, prob, ge, yg, thr, NG, cleanup_g_mask=cg), n=20)
    t0 = time.perf_counter()
    editor_fused.update_fused(_to(ts, "cpu"), logits.cpu(), ge.cpu(),
                              yg.cpu(), thr, NG, cleanup_g_mask=cg.cpu())
    plain_ms = (time.perf_counter() - t0) * 1e3
    bound_ms, bound_by = editor_bound((ts, logits, ge, yg, thr, None), cg)
    emit(phase="partition", case="mini_edit", columns_pp=ts.E_pp.shape[1],
         columns_pq=ts.E_pq.shape[1], grains=NG, cleanup_grains=int(cg.sum()),
         ms=ms, plain_ms=plain_ms, max_abs_err=err)
    return dict(name="editor_mini_edit", route="cuda",
                source="graingraphnn_torch/csrc/editor.cu",
                replaces=REPLACES["editor"], max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None, launches=launches,
                check=f"pass: integers bit-equal, floats atol {EDITOR_ATOL}, "
                      "the first partitioned span's mini edit, cleanup mask "
                      "set")


def phase_partition(reg, cls, dev, smi, workdir, traj240, pf, pf_line):
    """The partitioned rollout on the card (PART): 120 um at D = 4 over
    gloo, each span against the one-device span; 240 um at D = 8 on the
    column tables against the one-device run; D = 1 over NCCL; the PF
    recipe through cli.test --partition; the kernels at the stripe shapes
    and at the mini edit's. Returns the kernels line's rows."""
    fixture = dd.load_fixture()
    runs = {}
    # the backend rule picks gloo for ranks that share the card, NCCL for
    # the one rank that has it alone
    for name, D, arrays, n, check, kw, backend in (
            ("120um", PART["D"], fixture, PART["spans"], "span", {}, "gloo"),
            ("240um", PART["D240"], (traj240.x, traj240.edges, traj240.mask,
                                     traj240.lxd, traj240.patch_size),
             PART["spans240"], "trajectory",
             {"incremental": True, "wq": PART["wq240"]}, "gloo"),
            ("120um_nccl", 1, fixture, PART["nccl_spans"], "span", {},
             "nccl")):
        t0 = time.perf_counter()
        res = mesh_mod.launch(partition_rank, D, arrays, n, check,
                              kw.get("incremental", False),
                              kw.get("wq", 1024), device="cuda", timeout=600)
        check_partition_run(name, res, n, D, backend)
        runs[name] = res
        emit(phase="partition", case=name, nvidia_smi=smi,
             seconds=time.perf_counter() - t0, **partition_summary(res, n))

    npz = os.path.join(workdir, "pf.npz")
    arrays, G, R, frames = pf
    np.savez(npz, G=G, R=R, frames=frames,
             **{f"a_{k}": v for k, v in arrays.items()})
    with pf_source(pf, workdir) as rawdat:
        argv = ["--model_dir", "artifacts/40um", "--seed", str(PF["seed"]),
                "--rawdat_dir", rawdat, "--device_resident", "--eval_every",
                str(PF["eval_every"]), "--partition", str(PART["cli_D"])]
        t0 = time.perf_counter()
        out = mesh_mod.launch(pf_partition_rank, PART["cli_D"], argv, npz,
                              device="cuda", timeout=600)
        wall = time.perf_counter() - t0
    res = out[0][0]
    line = {"final_layer_error": res["final_layer_error"],
            "mean_layer_error": res["mean_layer_error"],
            "events_tp": res["events_tp"], "events_truth": res["events_truth"],
            "events_pred": res["events_pred"], "KS": res.get("KS"),
            "inference_time_s": round(res["inference_time"], 2)}
    print(json.dumps(line), flush=True)
    if line["final_layer_error"] is None or line["KS"] is None:
        raise RuntimeError(f"partition cli: no comparison: {line}")
    for rank, (_r, launches, retries, digest) in enumerate(out):
        if (launches["node_proj"] != 12 * PF["spans"]
                or launches["edge_attn"] != 12 * PF["spans"]
                or launches["cell_update"] != 4 * PF["spans"]
                or launches["editor"] != PF["spans"] + retries):
            raise RuntimeError(f"partition cli: rank {rank} launches "
                               f"{launches}, retries {retries}")
        if digest is None or digest != out[0][3]:
            raise RuntimeError(f"partition cli: rank {rank}'s final state "
                               "differs from rank 0's")
    same_events = all(line[k] == pf_line[k]
                      for k in ("events_tp", "events_truth", "events_pred"))
    emit(phase="partition", case="cli_pf", nvidia_smi=smi,
         ranks=PART["cli_D"], seconds=wall, cli=line,
         one_device_cli=pf_line, same_events_as_one_device=same_events,
         editor_retries=out[0][2],
         launches_per_rank=[o[1] for o in out])
    if not same_events:
        raise RuntimeError(f"partition cli: events {line} differ from the "
                           f"one-device CLI's {pf_line}")

    top = runs["120um"][0]
    rows = conv_kernel_rows(stripe_conv_inputs(reg, cls, fixture,
                                               PART["D"], dev),
                            reg.hp.layer_size, suffix="_stripe",
                            workload="partition")
    kernels = [dict(row, launches=top["by_shape"].get(key, 0))
               for key, row in rows.items()]
    kernels.append(mini_editor_row(top["mini_edit"],
                                   top["launches"]["editor"]))
    return kernels


# ---------------------------------------------------------------------------
# distributed training
# ---------------------------------------------------------------------------


def params_digest(model):
    h = hashlib.sha256()
    for name, p in model.named_parameters():
        h.update(name.encode())
        h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


DIST_STEPS = {"partitioned": partition.make_partitioned_train_step,
              "halo": halo.make_halo_train_step,
              "hybrid": partition.make_hybrid_train_step,
              "dp": data_parallel.make_dp_train_step}


def dist_step_check(mesh, kind, name, data, ref, axes):
    """One SGD(lr=1) step of the distributed train step `kind` of the
    shipped checkpoint `name` on `data`, timed; on rank 0 the one-rank
    step's loss and gradients on `ref` (the same graphs, one packed
    sample) from the same weights: the loss within TRAIN_LOSS_RTOL, the
    update (= the summed gradient) within TRAIN_GRAD_ATOL +
    TRAIN_GRAD_RTOL |g| of the one-rank gradient. Every rank returns its
    parameters' digest and the ranks of its group."""
    dev = mesh.device
    model, hp, _ = checkpoint.load_model(f"artifacts/40um/{name}", dev)
    p0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    opt = torch.optim.SGD(model.parameters(), lr=1.0)
    sched = torch.optim.lr_scheduler.StepLR(opt, step_size=1 << 30)
    step = DIST_STEPS[kind](hp, model, opt, sched, mesh, **axes)
    mesh.bytes_exchanged = mesh.bytes_gathered = mesh.bytes_reduced = 0
    sync(dev)
    t0 = time.perf_counter()
    loss = float(step(data))
    out = {"loss": loss, "ms": (time.perf_counter() - t0) * 1e3,
           "digest": params_digest(model),
           # the ranks that reduced this step's gradients together
           "peers": mesh.peers(axes.get("axis")),
           "bytes_sent": {"exchange": mesh.bytes_exchanged,
                          "all_gather": mesh.bytes_gathered,
                          "all_reduce": mesh.bytes_reduced}}
    if mesh.rank != 0:
        return out
    one, _, _ = checkpoint.load_model(f"artifacts/40um/{name}", dev)
    l_ref, _ = trainer.make_loss_fn(hp)(one, ref, kernels=False)
    l_ref.backward()
    err, worst = 0.0, None
    for (n, p), (_, q) in zip(model.named_parameters(),
                              one.named_parameters()):
        g = (q.grad if q.grad is not None else torch.zeros_like(q)).detach()
        d = (p0[n] - p.detach() - g).abs()
        if bool((d > TRAIN_GRAD_ATOL + TRAIN_GRAD_RTOL * g.abs()).any()):
            worst = worst or n
        err = max(err, d.max().item())
    out.update(loss_one_rank=l_ref.item(),
               loss_rel_err=abs(loss - l_ref.item()) / abs(l_ref.item()),
               update_max_abs_err=err, update_outside_tolerance=worst)
    return out


def dist_cli_runs(mesh, data, workdir, halo_D):
    """cli.dist_train's main on this group, per --partition (a mesh on its
    layout built anew for every run): 2 epochs; 1 epoch; a run resumed
    from the 1-epoch checkpoint to epoch 2; and that resume with a
    planted fault, the optimizer's and schedule's state not restored,
    which the resume check must catch. A halo layout of fewer stripes
    than ranks is left to the launcher (main without a mesh). Returns
    {partition: (full, first, resumed, planted)} summaries."""
    from graingraphnn_torch.cli import dist_train

    out = {}
    for part in DIST["partitions"]:
        base = ["--dataset", data, "--model_type", "regressor",
                "--model_id", "0", "--n_devices", str(mesh.D),
                "--platform", "gpu" if mesh.device.type == "cuda" else "cpu",
                "--partition", part] + (
                    ["--gp", str(halo_D)] if part == "halo" else [])
        n, axes = dist_train.layout(dist_train.parse(base), mesh.D)
        if n != mesh.D:
            continue

        def run(extra):
            m = mesh_mod.make_mesh(mesh.D, mesh.rank, mesh.backend,
                                   mesh.device, axes)
            with contextlib.redirect_stdout(io.StringIO()):
                return dist_train.main(base + extra, mesh=m)

        d = os.path.join(workdir, part)
        full = run(["--epochs", str(DIST["epochs"]), "--model_dir",
                    f"{d}_full"])
        first = run(["--epochs", "1", "--model_dir", f"{d}_epoch1"])
        resume = ["--epochs", str(DIST["epochs"]), "--resume",
                  first["checkpoint"]]
        resumed = run(resume + ["--model_dir", f"{d}_resumed"])
        with mock.patch.object(checkpoint, "restore_opt_state",
                               lambda *a: None):
            planted = run(resume + ["--model_dir", f"{d}_planted"])
        out[part] = (full, first, resumed, planted)
    return out


def dist_rank(mesh, data, workdir, halo_D):
    """One rank of the dist_train phase on DIST's (dp, gp) mesh: the
    partitioned forward of both shipped models on the 120 um fixture
    (rows padded to a multiple of D), counted after a warm-up, and on
    rank 0 against the one-device forward; the distributed train steps
    against the one-rank step; cli.dist_train's runs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = mesh.device
    out = dict(rank=mesh.rank, backend=mesh.backend,
               transport=mesh.transport)
    models = {n: checkpoint.load_model(f"artifacts/40um/{c}", dev)[0].eval()
              for n, c in (("regressor", "regressor0"),
                           ("classifier", "classifier1"))}
    st, _, _ = dd.init_scaled_state(*dd.load_fixture(), device=dev)
    sample = partition.pad_rows(dr.make_sample(st)[0], mesh.D)
    fwd = {n: partition.make_partitioned_forward(m, mesh)
           for n, m in models.items()}
    for f in fwd.values():                       # warm-up
        f(sample)
    sync(dev)
    mesh.barrier()
    reset_launches()
    mesh.bytes_gathered = 0
    t0 = time.perf_counter()
    ys = {n: f(sample) for n, f in fwd.items()}
    sync(dev)
    launches = counted_launches()
    out.update(forward_ms=(time.perf_counter() - t0) * 1e3,
               forward_launches=jsonable(launches),
               forward_by_shape=dict(launches["by_shape"]),
               forward_bytes_gathered=mesh.bytes_gathered)
    if mesh.rank == 0:
        err = {}
        with torch.no_grad():
            for n, m in models.items():
                for k, v in m(sample, kernels=True).items():
                    d = (ys[n][k] - v).abs()
                    err[f"{n}.{k}"] = d.max().item()
                    if bool((d > DIST_FWD_TOL + DIST_FWD_TOL * v.abs())
                            .any()) or not bool(torch.isfinite(ys[n][k])
                                                .all()):
                        raise RuntimeError(f"dist_train forward {n}.{k}: "
                                           f"max abs err {err[f'{n}.{k}']}")
        out["forward_max_abs_err"] = err

    raw = checkpoint.load_pickle(data)
    train = train_cli_mod.load_datasets(data, dev)[0].samples
    r0 = raw[0]
    striped = halo.build_striped(
        r0["feature_dicts"], r0["edge_index_dicts"], r0["edge_weight_dicts"],
        {"grain": r0["mask"]["grain"], "joint": r0["mask"]["joint"]},
        halo_D, dict(r0["target_dicts"]))[0]
    packed = lambda k: gstate.pack(gstate.stack(train[:k]))
    stacked = lambda k: gstate.stack(train[:k])
    hb, db = DIST["hybrid_batch"], DIST["dp_batch"]
    cases = {
        "partitioned_regressor": ("partitioned", "regressor0", train[0],
                                  packed(1), {}),
        "partitioned_classifier": ("partitioned", "classifier1", train[0],
                                   packed(1), {}),
        f"halo_D{halo_D}": ("halo", "regressor0", striped, packed(1),
                            {} if halo_D == mesh.D else {"axis": "gp"}),
        "hybrid_dp2_gp2": ("hybrid", "regressor0", stacked(hb), packed(hb),
                           {}),
        "dp_D2": ("dp", "regressor0", stacked(db), packed(db),
                  {"axis": "dp"}),
    }
    out["steps"] = {k: dist_step_check(mesh, *v) for k, v in cases.items()}
    out["cli"] = dist_cli_runs(mesh, data, workdir, halo_D)
    return out


def dist_nccl_rank(mesh, data):
    """The dp step at D = 1 on a card of its own (NCCL: the gradient
    bucket's all_reduce goes through it) against the one-rank step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    train = train_cli_mod.load_datasets(data, mesh.device)[0].samples
    k = DIST["nccl_batch"]
    res = dist_step_check(mesh, "dp", "regressor0",
                          gstate.stack(train[:k]),
                          gstate.pack(gstate.stack(train[:k])), {})
    return dict(res, rank=mesh.rank, backend=mesh.backend,
                transport=mesh.transport)


def halo_stripes(data):
    """The largest of DIST["halo_D"] whose stripes every train window
    allows (stripe width over the interaction range)."""
    raw = checkpoint.load_pickle(data)
    for D in DIST["halo_D"]:
        try:
            for r in raw:
                halo.build_striped(
                    r["feature_dicts"], r["edge_index_dicts"],
                    r["edge_weight_dicts"],
                    {"grain": r["mask"]["grain"],
                     "joint": r["mask"]["joint"]}, D)
            return D
        except ValueError:
            continue
    raise RuntimeError("dist_train: no halo stripe count fits the windows")


def rel_diff(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def check_step(name, r):
    if r.get("update_outside_tolerance") or not (
            r["loss_rel_err"] <= TRAIN_LOSS_RTOL):
        raise RuntimeError(
            f"dist_train step {name}: loss {r['loss']} against "
            f"{r['loss_one_rank']}, update err {r['update_max_abs_err']} "
            f"({r['update_outside_tolerance']})")


def gathered_conv_inputs(reg, sample, D):
    """Rank 0's decoder conv inputs in the partitioned forward: the whole
    gathered source table (Ns = N), the first of D destination blocks
    (Nd = N / D) with its ELL rows, global indices."""
    out = {}
    for name, (conv, xs, xd, nbr, ln, m) in decoder_conv_inputs(
            reg, sample).items():
        b = xd.shape[0] // D
        out[name] = (conv, xs, xd[:b].contiguous(), nbr[:b].contiguous(),
                     ln[:b].contiguous(), m[:b].contiguous())
    return out


def phase_dist_train(reg, dev, smi, workdir):
    """The training half of the parallel layer on the card (DIST): the
    partitioned forward at D = 4 against the one-device forward, counted
    per rank; each distributed train step against the one-rank step;
    the dp step at D = 1 over NCCL; cli.dist_train per --partition (in
    the ranks, and once through its own launcher), its checkpoints loaded
    and one run through cli.test; the kernels at the gathered shapes.
    Returns the kernels line's rows."""
    from graingraphnn_torch.cli import dist_train
    from graingraphnn_torch.cli import test as test_cli

    data = os.path.join(workdir, "train.pkl")
    write_train_pickle(data)
    halo_D = halo_stripes(data)
    D = DIST["D"]
    t0 = time.perf_counter()
    res = mesh_mod.launch(dist_rank, D, data, workdir, halo_D,
                          device="cuda", axes=DIST["axes"], timeout=900)
    seconds = time.perf_counter() - t0
    top = res[0]
    for r in res:
        l = r["forward_launches"]
        if r["backend"] != "gloo" or (
                l["node_proj"], l["edge_attn"], l["cell_update"]) != (12, 12, 4):
            raise RuntimeError(f"dist_train forward: rank {r['rank']} on "
                               f"{r['backend']}, launches {l}")
        for k, v in r["steps"].items():
            # a group's ranks hold one set of parameters; two dp groups
            # differ in the last bits (the backward's atomics)
            lead = res[v["peers"][0]]["steps"][k]["digest"]
            if v["digest"] != lead:
                raise RuntimeError(f"dist_train step {k}: rank {r['rank']}'s "
                                   "parameters differ from rank "
                                   f"{v['peers'][0]}'s")
    for k, v in top["steps"].items():
        check_step(k, v)
    emit(phase="dist_train", case="forward", nvidia_smi=smi, ranks=D,
         backend=top["backend"], transport=top["transport"],
         seconds=seconds, forward_ms=[r["forward_ms"] for r in res],
         launches_per_rank=[{k: r["forward_launches"][k]
                             for k in ("node_proj", "edge_attn")}
                            for r in res],
         bytes_gathered_per_rank=top["forward_bytes_gathered"],
         max_abs_err=top["forward_max_abs_err"], tol=DIST_FWD_TOL)
    emit(phase="dist_train", case="steps", nvidia_smi=smi, halo_D=halo_D,
         steps={k: {kk: vv for kk, vv in v.items() if kk != "digest"}
                for k, v in top["steps"].items()},
         tolerances={"loss_rtol": TRAIN_LOSS_RTOL,
                     "grad_atol": TRAIN_GRAD_ATOL,
                     "grad_rtol": TRAIN_GRAD_RTOL})

    nccl = mesh_mod.launch(dist_nccl_rank, 1, data, device="cuda",
                           timeout=600)[0]
    check_step("dp_D1_nccl", nccl)
    if nccl["backend"] != "nccl" or nccl["bytes_sent"]["all_reduce"] <= 0:
        raise RuntimeError(f"dist_train nccl: {nccl['backend']}, "
                           f"{nccl['bytes_sent']}")
    emit(phase="dist_train", case="dp_D1_nccl", nvidia_smi=smi,
         **{k: v for k, v in nccl.items() if k != "digest"})

    # cli.dist_train: the ranks' runs, then the launcher's own for dp
    cli = dict(top["cli"])
    argv = ["--dataset", data, "--model_type", "regressor", "--model_id",
            "0", "--n_devices", str(D), "--epochs", str(DIST["epochs"])]
    for part in DIST["partitions"]:
        if part in cli:
            continue
        extra = ["--gp", str(halo_D)] if part == "halo" else []
        full = dist_train.main(argv + ["--partition", part, "--model_dir",
                                       os.path.join(workdir, "launch_"
                                                    + part)] + extra)
        cli[part] = (full, None, None, None)
    with contextlib.redirect_stdout(io.StringIO()):
        launched = dist_train.main(argv + ["--partition", "dp",
                                           "--model_dir", os.path.join(
                                               workdir, "launch_dp")])
    summary = {}
    for part, (full, first, resumed, planted) in cli.items():
        losses = full["train_loss"]
        if len(losses) != DIST["epochs"] or not np.isfinite(losses).all():
            raise RuntimeError(f"dist_train cli {part}: losses {losses}")
        model, hp, _ = checkpoint.load_model(full["checkpoint"], dev)
        summary[part] = dict(
            ranks=full["ranks"], axes=full["axes"], train_loss=losses,
            steps=len(full["step_ms"]),
            ms_per_step=sum(full["step_ms"]) / max(len(full["step_ms"]), 1),
            bytes_sent_per_rank=full["bytes_sent"],
            checkpoint_params=grain_nn.count_params(model))
        if resumed is not None:
            rel = [rel_diff(first["train_loss"][0], losses[0]),
                   rel_diff(resumed["train_loss"][0], losses[1])]
            planted_rel = rel_diff(planted["train_loss"][0], losses[1])
            summary[part].update(resumed_epoch2_loss=resumed["train_loss"],
                                 resumed_rel_diff=rel,
                                 resumed_bit_equal=resumed["train_loss"]
                                 == losses[1:],
                                 planted_epoch2_loss=planted["train_loss"],
                                 planted_rel_diff=planted_rel)
            if len(resumed["train_loss"]) != 1 or not max(rel) <= \
                    DIST_RESUME_RTOL:
                raise RuntimeError(
                    f"dist_train cli {part}: resumed {resumed['train_loss']}"
                    f" after {first['train_loss']}, uninterrupted {losses}")
            if not planted_rel > DIST_RESUME_RTOL:
                raise RuntimeError(
                    f"dist_train cli {part}: a resume without the optimizer "
                    f"state ({planted['train_loss']}) passes the resume "
                    f"check against {losses[1]}")
    launcher_rel = [rel_diff(a, b) for a, b in zip(
        launched["train_loss"], cli["dp"][0]["train_loss"])]
    if len(launcher_rel) != DIST["epochs"] or not max(launcher_rel) <= \
            DIST_RESUME_RTOL:
        raise RuntimeError(f"dist_train cli: the launcher's dp run "
                           f"{launched['train_loss']} against the ranks' "
                           f"{cli['dp'][0]['train_loss']}")
    # the dp checkpoint rolls out through cli.test, as regressor0 beside
    # the shipped classifier
    mdir = os.path.join(workdir, "cli_test_models")
    os.makedirs(mdir)
    for ext in (".ckpt", ".json"):
        shutil.copy(launched["checkpoint"] + ext,
                    os.path.join(mdir, "regressor0" + ext))
        shutil.copy("artifacts/40um/classifier1" + ext, mdir)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        test_cli.main(["--generate", "--device_resident", "--model_dir",
                       mdir, "--seed", "3", "--G", "4", "--R", "1",
                       "--eval_every", "5", "--growth_height", "4.8"])
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    emit(phase="dist_train", case="cli", nvidia_smi=smi, runs=summary,
         launcher_dp_loss=launched["train_loss"],
         launcher_dp_rel_diff=launcher_rel,
         launcher_ms_per_step=sum(launched["step_ms"])
         / max(len(launched["step_ms"]), 1),
         resume_rtol=DIST_RESUME_RTOL, cli_test=line)

    sample = partition.pad_rows(dr.make_sample(dd.init_scaled_state(
        *dd.load_fixture(), device=dev)[0])[0], D)
    with torch.no_grad():
        rows = conv_kernel_rows(gathered_conv_inputs(reg, sample, D),
                                reg.hp.layer_size, suffix="_gathered",
                                workload="dist_train")
    return [dict(row, launches=top["forward_by_shape"].get(key, 0))
            for key, row in rows.items()]


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------


def write_train_pickle(path, n=TRAIN["samples"], ng=TRAIN["ng"]):
    """n synthetic graphs (spatial_ring_arrays, seeds 0..n-1: ng grains and
    2 ng joints) in cli.extract --mode=train's pickle layout."""
    raw = []
    for seed in range(n):
        f, e, w, m, t = synthetic.spatial_ring_arrays(ng, seed=seed)
        raw.append({"feature_dicts": f, "target_dicts": t,
                    "edge_index_dicts": e, "edge_weight_dicts": w,
                    "mask": m, "physical_params": {"G": 1.904, "R": 0.558},
                    "span": 6})
    with open(path, "wb") as fh:
        pickle.dump(raw, fh)


class StepTimer:
    """Times every train step (trainer.make_train_step's step function)
    with CUDA events around it, for the duration of a with block."""

    def __init__(self):
        self.events = []

    def __enter__(self):
        orig = trainer.make_train_step

        def make(*a, **k):
            step = orig(*a, **k)

            def timed(batch):
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                out = step(batch)
                e1.record()
                self.events.append((e0, e1))
                return out
            return timed

        self._patch = mock.patch.object(trainer, "make_train_step", make)
        self._patch.__enter__()
        return self

    def __exit__(self, *exc):
        self._patch.__exit__(*exc)

    def ms(self):
        torch.cuda.synchronize()
        return [e0.elapsed_time(e1) for e0, e1 in self.events]


class EpochSyncs:
    """Counts the host syncs of each trainer.run_epoch call (PyTorch's sync
    debug mode warns on every synchronizing call) and times it on the
    host clock (an epoch ends on its one sync)."""

    def __init__(self):
        self.syncs, self.ms = [], []

    def __enter__(self):
        orig = trainer.run_epoch

        def run(*a, **k):
            torch.cuda.synchronize()
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                torch.cuda.set_sync_debug_mode("warn")
                t0 = time.perf_counter()
                try:
                    out = orig(*a, **k)
                finally:
                    self.ms.append((time.perf_counter() - t0) * 1e3)
                    torch.cuda.set_sync_debug_mode("default")
            self.syncs.append(sum("synchroniz" in str(w.message)
                                  for w in caught))
            return out

        self._patch = mock.patch.object(trainer, "run_epoch", run)
        self._patch.__enter__()
        return self

    def __exit__(self, *exc):
        self._patch.__exit__(*exc)


def train_cli(args):
    """cli.train on args; its standard output."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train_cli_mod.main(args)
    return out.getvalue()


def step_card_vs_cpu(model, hp, batch):
    """One train step's forward and backward (the torch formulation) on the
    card and on a CPU copy of the same params and packed batch: the loss
    within TRAIN_LOSS_RTOL, every gradient within TRAIN_GRAD_ATOL +
    TRAIN_GRAD_RTOL |g|. Then the eval forward on the hand kernels against
    the torch formulation on the card, within ATOL + RTOL |ref|. Returns
    the errors."""
    cpu_model = copy.deepcopy(model).cpu()
    model.zero_grad(set_to_none=True)
    cpu_model.zero_grad(set_to_none=True)
    loss_fn = trainer.make_loss_fn(hp)
    cell_update.launches = 0
    l1, _ = loss_fn(model, batch, kernels=False)
    l1.backward()
    if cell_update.launches:
        raise RuntimeError(f"train step: {cell_update.launches} launches of "
                           "the cells' update kernel")
    l0, _ = loss_fn(cpu_model, batch.to("cpu"), kernels=False)
    l0.backward()
    l1, l0 = l1.item(), l0.item()
    loss_rel = abs(l1 - l0) / abs(l0)
    if not loss_rel <= TRAIN_LOSS_RTOL:
        raise RuntimeError(f"train step: loss {l1} on the card, {l0} on "
                           "the CPU")
    grad_err = 0.0
    for (name, p1), (_, p0) in zip(model.named_parameters(),
                                   cpu_model.named_parameters()):
        if (p1.grad is None) != (p0.grad is None):
            raise RuntimeError(f"train step: {name} has a grad on one side")
        if p1.grad is None:
            continue
        d = (p1.grad.cpu() - p0.grad).abs()
        if bool((d > TRAIN_GRAD_ATOL + TRAIN_GRAD_RTOL * p0.grad.abs()).any()):
            raise RuntimeError(f"train step: {name} grad max abs err "
                               f"{d.max().item()}")
        grad_err = max(grad_err, d.max().item())
    model.zero_grad(set_to_none=True)
    with torch.no_grad():
        fast = model(batch, kernels=True)
        slow = model(batch, kernels=False)
    eval_err = max(close(f"eval forward {k}", fast[k], slow[k])[0]
                   for k in fast)
    return {"loss_card": l1, "loss_cpu": l0,
            "loss_rel_err": loss_rel, "grad_max_abs_err": grad_err,
            "eval_max_abs_err": eval_err}


def eval_launches(model, hp, batch):
    """The kernel launches of one eval forward (trainer.make_eval_fn)."""
    reset_launches()
    trainer.make_eval_fn(hp, model)(batch)
    torch.cuda.synchronize()
    return dict(edge_stage.launches, cell_update=cell_update.launches)


def profile_train_steps(model, hp, batch, n=4, top=8):
    """n train steps (as trainer.train runs them: each ends on reading its
    loss) of `model` on the packed `batch` under torch.profiler: wall ms a
    step, device ms a step, the device's busy share, CUDA kernels a step
    and the largest by device time."""
    from torch.profiler import ProfilerActivity, profile

    opt, sched = trainer.make_optimizer(hp, model, 1000)
    step = trainer.make_train_step(hp, model, opt, sched)
    for _ in range(2):
        float(step(batch))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            float(step(batch))
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(ev.key, getattr(ev, "self_device_time_total", 0) / 1e3, ev.count)
            for ev in prof.key_averages()
            if str(ev.device_type).endswith("CUDA")]
    rows.sort(key=lambda r: -r[1])
    device_ms = sum(r[1] for r in rows)
    return {"B": hp.batch_size, "wall_ms_per_step": wall / n,
            "device_ms_per_step": device_ms / n,
            "device_busy_share": device_ms / wall,
            "kernels_per_step": sum(r[2] for r in rows) / n,
            "top": [{"name": k[:80], "ms_per_step": ms / n, "count": c / n}
                    for k, ms, c in rows[:top]]}


def phase_train(state, smi, workdir, profile=False):
    """The training path on the card at the shipped configs' full width:
    cli.train on a synthetic 40 um corpus (the regressor, then the transfer
    classifier from it), counted like the rollout; train_scanned with G,R
    jitter; one step card against CPU; the eval forward's launches; the
    saved checkpoints loaded and run for one span of the 120 um rollout.
    Returns the kernels line's rows at the packed training shapes."""
    dev = torch.device("cuda")
    data = os.path.join(workdir, "train.pkl")
    mdir = os.path.join(workdir, "model")
    write_train_pickle(data)
    train_ds, valid_ds = train_cli_mod.load_datasets(data, dev)
    n_train, n_valid = len(train_ds), len(valid_ds)
    runs, want = {}, {"node_proj": 0, "edge_attn": 0, "cell_update": 0}
    reset_launches()
    for name in ("regressor0", "classifier1"):
        hp = checkpoint.load_hp(f"artifacts/40um/{name}")
        # every eval forward launches each conv kernel 6 times and the
        # cells' update twice; the train steps (the torch formulation) none
        n_eval = (-(-n_train // hp.batch_size)
                  + (TRAIN["epochs"] + 1) * -(-n_valid // 64))
        for k in want:
            want[k] += (2 if k == "cell_update" else 6) * n_eval
        torch.cuda.synchronize()
        resident = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with StepTimer() as timer:
            log = train_cli(["--dataset", data, "--model_dir", mdir,
                             "--epochs", str(TRAIN["epochs"]),
                             "--config", f"artifacts/40um/{name}.json"])
        torch.cuda.synchronize()
        ms = timer.ms()
        runs[name] = dict(
            seconds=time.perf_counter() - t0, steps=len(ms),
            ms_per_step=sum(ms) / len(ms), step_ms=ms,
            peak_mem_bytes=torch.cuda.max_memory_allocated(),
            resident_mem_bytes=resident,
            log_tail=log.strip().splitlines()[-3:])
        # train() keeps the last, partial batch of an epoch
        if len(ms) != TRAIN["epochs"] * -(-n_train // hp.batch_size):
            raise RuntimeError(f"train {name}: {len(ms)} steps")
    launches = {"node_proj": edge_stage.launches["node_proj"],
                "edge_attn": edge_stage.launches["edge_attn"],
                "cell_update": cell_update.launches,
                "by_shape": dict(edge_stage.shape_launches)}
    if {k: launches[k] for k in want} != want:
        raise RuntimeError(f"train: launches {launches}, want {want}")

    # train_scanned with G,R jitter, on a fresh regressor0
    hp = checkpoint.load_hp("artifacts/40um/regressor0")
    model = grain_nn.init_regressor(
        hp, torch.Generator().manual_seed(0)).to(dev)
    with EpochSyncs() as ep:
        _, hist = trainer.train_scanned(
            hp, model, train_ds, valid_ds, epochs=TRAIN["epochs"],
            gr_jitter=True, log=lambda line: None)
    if ep.syncs != [1] * TRAIN["epochs"]:
        raise RuntimeError(f"train_scanned: host syncs per epoch {ep.syncs}")
    if not np.isfinite(hist["train_loss"]).all():
        raise RuntimeError(f"train_scanned: losses {hist['train_loss']}")

    # the saved checkpoints: card against CPU, eval launches, a rollout span
    B = TRAIN["eval_B"]
    batch = gstate.pack(gstate.stack(train_ds.samples[:B]))
    checks, eval_counts, models, profiles = {}, {}, {}, {}
    for name in ("regressor0", "classifier1"):
        if profile:
            model, hp_m, _ = checkpoint.load_model(os.path.join(mdir, name), dev)
            profiles[name] = profile_train_steps(model, hp_m, gstate.pack(
                gstate.stack(train_ds.samples[:hp_m.batch_size])))
        model, hp_m, _ = checkpoint.load_model(os.path.join(mdir, name), dev)
        checks[name] = step_card_vs_cpu(model, hp_m, batch)
        eval_counts[name] = eval_launches(model, hp_m, batch)
        if eval_counts[name] != {"node_proj": 6, "edge_attn": 6,
                                 "cell_update": 2}:
            raise RuntimeError(f"eval forward of {name}: {eval_counts[name]}")
        models[name] = model
    reset_launches()
    with torch.no_grad():
        s1, aux = dr.device_step(models["regressor0"], models["classifier1"],
                                 state, c_threshold=C_THRESHOLD)
    torch.cuda.synchronize()
    span = {"node_proj": edge_stage.launches["node_proj"],
            "edge_attn": edge_stage.launches["edge_attn"],
            "editor": editor_fused.launches,
            "cell_update": cell_update.launches}
    if span != {"node_proj": 12, "edge_attn": 12, "editor": 1,
                "cell_update": 4} or not (
            bool(torch.isfinite(s1.xj).all()) and bool(torch.isfinite(s1.xg).all())):
        raise RuntimeError(f"span with the trained checkpoints: {span}")

    with torch.no_grad():
        rows = conv_kernel_rows(
            decoder_conv_inputs(models["regressor0"], batch),
            hp.layer_size, suffix=f"_train{B}", workload=f"train_B{B}")
    for key, row in rows.items():
        row["launches"] = launches["by_shape"].get(key, 0)
    emit(phase="train", nvidia_smi=smi, samples=TRAIN["samples"],
         n_train=n_train, n_valid=n_valid, grains=TRAIN["ng"],
         joints=2 * TRAIN["ng"], epochs=TRAIN["epochs"], cli=runs,
         launches={k: ({str(kk): vv for kk, vv in v.items()}
                       if k == "by_shape" else v)
                   for k, v in launches.items()},
         scanned={"ms_per_epoch": ep.ms, "host_syncs_per_epoch": ep.syncs,
                  "train_loss": hist["train_loss"],
                  "valid_loss": hist["valid_loss"]},
         card_vs_cpu=checks, eval_launches=eval_counts,
         tolerances={"loss_rtol": TRAIN_LOSS_RTOL,
                     "grad_atol": TRAIN_GRAD_ATOL,
                     "grad_rtol": TRAIN_GRAD_RTOL,
                     "eval_atol": ATOL, "eval_rtol": RTOL},
         trained_span={"launches": span,
                       "switches": int((aux["switching"][:, 0] >= 0).sum())},
         profile=profiles or None)
    return rows


# ---------------------------------------------------------------------------
# the bf16 edge stage (JAX's pallas=True rollout)
# ---------------------------------------------------------------------------


def bf16_span_card_vs_cpu(reg, cls, reg_cpu, cls_cpu, state):
    """One pallas=True span from the same state on the card (the bf16
    kernels) and on the CPU (their plain versions). A bf16 rounding that
    flips where the two sum in another order moves a switch probability by
    more than fp32 noise, so the window is measured on the span itself:
    the largest difference between the two forwards' probabilities. The
    topology must be bit-equal unless a probability of the CPU's forward
    lies within that window of the threshold; positions (the first two
    columns of xg and xj) within BF16_POS_MAX and BF16_POS_MEAN where it
    is."""
    st_cpu = state.map(lambda v: v.cpu())
    kw = dict(c_threshold=C_THRESHOLD, pallas=True)
    s1, a1 = dr.device_step(reg, cls, state, **kw)
    s0, _ = dr.device_step(reg_cpu, cls_cpu, st_cpu, **kw)
    p1, p0 = (torch.sigmoid(dr.forward_stage(r, c, st, tj.RING_MAX, "bf16")
                            [2]["edge_event"]).cpu()
              for r, c, st in ((reg, cls, state), (reg_cpu, cls_cpu, st_cpu)))
    live = st_cpu.E_pp[0] >= 0
    window = (p1 - p0)[live].abs().max().item()
    near = bool(((p0 - C_THRESHOLD)[live].abs() <= window).any())
    ints = ["E_pp", "E_pq", "mask_g", "mask_j", "n_pp"]
    same = all(torch.equal(getattr(s1, f).cpu(), getattr(s0, f))
               for f in ints)
    if not same and not near:
        raise RuntimeError("bf16 span: topology differs from the CPU span")
    d = torch.cat([(s1.xj[:, :2].cpu() - s0.xj[:, :2]).abs().reshape(-1),
                   (s1.xg[:, :2].cpu() - s0.xg[:, :2]).abs().reshape(-1)])
    pos_max, pos_mean = d.max().item(), d.mean().item()
    if same and not (pos_max <= BF16_POS_MAX and pos_mean <= BF16_POS_MEAN):
        raise RuntimeError(f"bf16 span: positions differ by {pos_max} at "
                           f"most, {pos_mean} in the mean")
    return dict(topology_equal=same, threshold_adjacent=near,
                probability_window=window, position_max_abs_err=pos_max,
                position_mean_abs_err=pos_mean,
                switches=int((a1["switching"][:, 0] >= 0).sum()),
                grain_events=int((a1["grain_events"] >= 0).sum()))


def library_fp32_out(b, x, w):
    """The library's bf16 product that writes fp32, as node_proj_bf16
    does: addmm on bf16 operands with out_dtype=float32 (an fp32 bias), or
    None with the reason where this torch has no such overload."""
    try:
        out = torch.addmm(b, x, w, out_dtype=torch.float32)
        torch.cuda.synchronize()
    except (TypeError, RuntimeError, NotImplementedError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"
    if out.dtype != torch.float32:
        return None, f"addmm(out_dtype=float32) returned {out.dtype}"
    return (lambda: torch.addmm(b, x, w, out_dtype=torch.float32)), None


def pack_ms(conv):
    """The one-time cost of the bf16 weight pack (edge_stage.pack_bf16) of
    conv: host ms of a cold build, ended on a synchronize, the cache of the
    conv dropped first; the pack is rebuilt for the calls that follow."""
    edge_stage._packs.pop(conv, None)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    edge_stage.pack_bf16(conv)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def bf16_kernel_rows(inputs, C, suffix=""):
    """Per conv of inputs {name: (conv, x_src, x_dst, nbr, len, mask)}: the
    fused bf16 conv, node_proj_bf16 and edge_attn_bf16 against their plain
    bf16 versions on the real masks, every 7th row masked and live slots
    dropped at random (close_bf16; the projections, whose products are
    exact, at the fp32 limits), the planted fault (the fp32 conv against
    the plain bf16 version, which must read above the mean limit), the
    weight pack's one-time ms, and the times, with two library yardsticks
    for node_proj_bf16: two bf16 addmm writing bf16 (half the kernel's
    bytes) and writing fp32. Returns {(kernel, F_src, F_dst): row} (row
    names end in suffix)."""
    G = cells.NUM_GATES
    GC = G * C
    kw = dict(num_gates=G, out_channels=C, precision="bf16")
    bf = torch.bfloat16
    rows = {}
    for name, (conv, xs, xd, nbr, ln, m) in inputs.items():
        K, Fs, Fd = nbr.shape[1], xs.shape[1], xd.shape[1]
        m_cut = m.clone()
        m_cut[::7] = 0.0
        gen = torch.Generator(device=m.device).manual_seed(K)
        m_scat = m * (torch.rand(m.shape, generator=gen,
                                 device=m.device) < 0.6)
        err = {"conv": 0.0, "node_proj": 0.0, "edge_attn": 0.0}
        mean = {"conv": 0.0, "edge_attn": 0.0}
        planted = math.inf
        pack = pack_ms(conv)
        proj = period_conv.node_projections_plain(conv, xs, xd, "bf16")
        for mask in (m, m_cut, m_scat):
            out = edge_stage.apply_period_conv_cuda(conv, xs, xd, nbr, ln,
                                                    mask, **kw)
            ref = period_conv.apply_period_conv_plain(conv, xs, xd, nbr, ln,
                                                      mask, **kw)
            e, r = close_bf16(f"bf16 edge stage {name}", out, ref)
            err["conv"], mean["conv"] = (max(err["conv"], e),
                                         max(mean["conv"], r))
            for k, (o, pr) in enumerate(zip(
                    edge_stage.node_proj_cuda(conv, xs, xd, "bf16"), proj)):
                e, _ = close(f"node_proj_bf16 {name} output {k}", o, pr)
                err["node_proj"] = max(err["node_proj"], e)
            out = edge_stage.edge_attn_cuda(conv, xs, xd, nbr, ln, mask,
                                            proj, **kw)
            e, r = close_bf16(f"edge_attn_bf16 {name}", out,
                              period_conv.edge_attn_plain(
                                  conv, xs, xd, nbr, ln, mask, proj, **kw))
            err["edge_attn"], mean["edge_attn"] = (
                max(err["edge_attn"], e), max(mean["edge_attn"], r))
            f32 = edge_stage.apply_period_conv_cuda(
                conv, xs, xd, nbr, ln, mask, num_gates=G, out_channels=C)
            planted = min(planted, ((f32 - ref).abs().mean()
                                    / ref.abs().max()).item())
        if not planted > BF16_MEAN_REL:
            raise RuntimeError(f"bf16 {name}: the fp32 conv reads {planted} "
                               "against the plain bf16 version, not above "
                               f"the mean limit {BF16_MEAN_REL}")
        # the library's yardsticks: two addmm on operands cast to bf16
        # before timing, writing bf16, and writing fp32 where torch can
        x_s, x_d = xs[:, 3:].to(bf), xd.to(bf)
        w_src = torch.cat([conv.key.w[3:], conv.value.w[3:]], 1).to(bf)
        w_dst = torch.cat([conv.query.w, conv.skip.w], 1).to(bf)
        b_src32 = torch.cat([conv.key.b, conv.value.b])
        b_dst32 = torch.cat([conv.query.b, conv.skip.b])
        b_src, b_dst = b_src32.to(bf), b_dst32.to(bf)
        f32_src, why = library_fp32_out(b_src32, x_s, w_src)
        f32_dst, _ = library_fp32_out(b_dst32, x_d, w_dst)
        t = {
            "conv": cuda_ms(lambda: edge_stage.apply_period_conv_cuda(
                conv, xs, xd, nbr, ln, m, **kw)),
            "node_proj": cuda_ms(lambda: edge_stage.node_proj_cuda(
                conv, xs, xd, "bf16")),
            "node_proj_plain": cuda_ms(
                lambda: period_conv.node_projections_plain(conv, xs, xd,
                                                           "bf16")),
            "node_proj_library": cuda_ms(lambda: (
                torch.addmm(b_src, x_s, w_src), torch.addmm(b_dst, x_d, w_dst))),
            "edge_attn": cuda_ms(lambda: edge_stage.edge_attn_cuda(
                conv, xs, xd, nbr, ln, m, proj, **kw)),
            "edge_attn_plain": cuda_ms(lambda: period_conv.edge_attn_plain(
                conv, xs, xd, nbr, ln, m, proj, **kw), n=20),
            "node_proj_library_fp32_out": None if f32_src is None else
                cuda_ms(lambda: (f32_src(), f32_dst())),
        }
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(100):
            edge_stage.apply_period_conv_cuda(conv, xs, xd, nbr, ln, m, **kw)
        conv_host_us = (time.perf_counter() - t0) * 1e4   # per call, issued
        torch.cuda.synchronize()
        (Ns, _), (Nd, _) = xs.shape, xd.shape
        np_flops, np_bytes = node_proj_cost(xs, xd, GC, bf16=True)
        np_bound, np_by = bound(np_bytes, (np_flops, PEAK_BF16))
        ea_tc, ea_fp32, ea_bytes = edge_attn_cost(xs, xd, m, G, C, bf16=True)
        ea_bound, ea_by = bound(ea_bytes, (ea_tc, PEAK_BF16),
                                (ea_fp32, PEAK_FP32))
        src = "graingraphnn_torch/csrc/edge_stage_bf16.cu"
        check = (f"pass: mean abs err <= {BF16_MEAN_REL} and max <= "
                 f"{BF16_MAX_REL} of max |plain bf16|, also fully masked "
                 "rows and scattered live slots")
        rows[("node_proj_bf16", Fs, Fd)] = dict(
            name=f"node_proj_{name}_bf16{suffix}", route="cuda", source=src,
            replaces=REPLACES[name], max_abs_err=err["node_proj"],
            ms=t["node_proj"], plain_ms=t["node_proj_plain"],
            bound_ms=np_bound, bound_by=np_by,
            library_ms=t["node_proj_library"],
            library_fp32_out_ms=t["node_proj_library_fp32_out"],
            pack_ms=pack,
            check=f"pass: atol {ATOL} rtol {RTOL} (exact products)")
        rows[("edge_attn_bf16", Fs, Fd)] = dict(
            name=f"edge_attn_{name}_bf16{suffix}", route="cuda", source=src,
            replaces=REPLACES[name], max_abs_err=err["edge_attn"],
            ms=t["edge_attn"], plain_ms=t["edge_attn_plain"],
            bound_ms=ea_bound, bound_by=ea_by, library_ms=None, check=check)
        # rows past edge_attn_bf16's first chunk of 8 live slots (their V
        # rows are gathered a second time), and the 32-row tiles with one
        live = (m > 0).sum(1)
        past = torch.nn.functional.pad(live > 8, (0, -Nd % 32))
        emit(phase="bf16_edge_stage", graph=suffix.strip("_") or "120um",
             conv=name, K=K, Ns=Ns, Nd=Nd,
             F_src=Fs, F_dst=Fd, live_edges=float(m.sum()),
             rows_by_live_slots=torch.bincount(live).tolist(),
             tiles_past_first_chunk=int(past.view(-1, 32).any(1).sum()),
             max_abs_err=err, mean_rel_err=mean, planted_fp32_mean_rel=planted,
             mean_limit=BF16_MEAN_REL, max_limit=BF16_MAX_REL, ms=t,
             library_fp32_out_refused=why, pack_ms=pack,
             conv_host_us=conv_host_us,
             node_proj_gflop=np_flops / 1e9, node_proj_mbytes=np_bytes / 1e6,
             node_proj_bound_ms=np_bound,
             node_proj_tflops=np_flops / t["node_proj"] / 1e9,
             edge_attn_bound_ms=ea_bound, edge_attn_mbytes=ea_bytes / 1e6)
    return rows


def bf16_ptxas(Fs=107, Fd=104, C=96, K=(3, 16)):
    """Each kernel of the bf16 source as ptxas built it in this run
    (registers, spill bytes, stack; from _build.build_log), and the
    dynamic shared memory a block takes at the rollout's widths, from the
    source's own sizes (edge_stage_bf16_smem)."""
    import re

    lines = next((v["ptxas"] for k, v in _build.build_log.items()
                  if k.split()[0] == edge_stage.SOURCE_BF16), [])
    kernels, cur = [], None
    for ln in lines:
        if "Compiling entry function" in ln:
            m = re.search(r"(node_proj_bf16|edge_attn_bf16)"
                          r"(?:ILi(\d+)ELi(\d+)ELi(\d+)E)?", ln)
            name = (m.group(1) + (f"<{m.group(2)},{m.group(3)},{m.group(4)}>"
                                  if m.group(2) else "")) if m else ln
            cur = {"kernel": name}
            kernels.append(cur)
        elif cur is not None and "registers" in ln:
            cur["registers"] = int(re.search(r"Used (\d+) registers",
                                             ln).group(1))
            sm = re.search(r"(\d+) bytes smem", ln)
            cur["static_smem"] = int(sm.group(1)) if sm else 0
        elif cur is not None and "spill" in ln:
            st, sp_st, sp_ld = (int(v) for v in re.findall(r"(\d+) bytes", ln)[:3])
            cur.update(stack=st, spill_stores=sp_st, spill_loads=sp_ld)
    fn = _build.library(edge_stage.SOURCE_BF16, edge_stage.NVCC_FLAGS
                        ).edge_stage_bf16_smem
    fn.argtypes, fn.restype = [ctypes.c_int] * 5, ctypes.c_int
    smem = {"node_proj_bf16, one stage": fn(1, Fs, Fd, C, 0),
            "node_proj_bf16, two stages": fn(2, Fs, Fd, C, 0),
            **{f"edge_attn_bf16, K = {k}": fn(0, Fs, Fd, C, k) for k in K}}
    return kernels, smem


def event_set(aux):
    """The grain and extra events of a run's spans, as a set."""
    return {int(g) for k in ("grain_events", "extra_events")
            for g in aux[k].reshape(-1).tolist() if g >= 0}


def phase_bf16(reg, cls, reg_cpu, cls_cpu, state, dev, trajs):
    """JAX's pallas=True rollout on the bf16 kernels: 20 spans of the 120
    um fixture (c_threshold 0.99) beside the fp32 rollout in the same
    call. The counted bf16 run (12 + 12 bf16 conv launches a span, no fp32
    conv launch, one editor launch; peak memory), ms a span and edges/s of
    each (min of 4, in turns fp32, bf16, bf16, fp32), the event Jaccard of
    the two runs' events (bench.py's metric, no limit set); one bf16 span
    against the CPU's; a batched bf16 run of 4 lanes against each lane's
    single-lane bf16 run; the bf16 kernels at the first span's decoder
    convs; cli.test --pallas on the 40 um recipe, with --pallas
    --partition 4 refused, and the kernels at that graph's decoder convs;
    a counted bf16 run of the 240 um graph and the kernels at its decoder
    convs. The kernels' ptxas lines and shared memory first. Returns the
    kernels line's rows, each with the launches of its graph's counted
    run."""
    from graingraphnn_torch.cli import test as cli

    ptxas, smem = bf16_ptxas()
    emit(phase="bf16_ptxas", kernels=ptxas, smem_bytes=smem)
    n = BF16["spans"]
    runs = {p: dr.make_rollout(reg, cls, n_steps=n, c_threshold=C_THRESHOLD,
                               pallas=p) for p in ("fp32", "bf16")}
    for run in runs.values():
        run(state)                                  # warm-ups
    torch.cuda.synchronize()
    reset_launches()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    final, aux = runs["bf16"](state)                # the counted run
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    launches = {"fp32": dict(edge_stage.launches),
                "bf16": dict(edge_stage.bf16_launches),
                "by_shape": dict(edge_stage.shape_launches),
                "editor": editor_fused.launches,
                "cell_update": cell_update.launches}
    if (launches["bf16"] != {"node_proj": 12 * n, "edge_attn": 12 * n}
            or any(launches["fp32"].values()) or launches["editor"] != n
            or launches["cell_update"] != 4 * n):
        raise RuntimeError(f"bf16 rollout: launches {launches}")
    for name in ("xg", "xj"):
        if not bool(torch.isfinite(getattr(final, name)).all()):
            raise RuntimeError(f"bf16 rollout: non-finite {name}")
    final32, aux32 = runs["fp32"](state)
    secs = {"fp32": [], "bf16": []}
    for p in ("fp32", "bf16", "bf16", "fp32") * (BF16["repeats"] // 2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        runs[p](state)
        torch.cuda.synchronize()
        secs[p].append(time.perf_counter() - t0)
    edges = {p: float(a["message_edges"].sum())
             for p, a in (("fp32", aux32), ("bf16", aux))}
    # where a span's time goes: the device's share of each run under the
    # profiler, and the aten calls the host issues in the first span
    profiles = {p: profile_run(run, state, top=6) for p, run in runs.items()}
    calls = {p: aten_calls(lambda p=p: dr.device_step(
        reg, cls, state, c_threshold=C_THRESHOLD, pallas=p))["span"]
        for p in runs}
    ev32, ev16 = event_set(aux32), event_set(aux)
    jaccard = len(ev32 & ev16) / max(len(ev32 | ev16), 1)
    emit(phase="bf16_rollout", spans=n, launches={
             k: ({str(kk): vv for kk, vv in v.items()} if k == "by_shape"
                 else v) for k, v in launches.items()},
         seconds=secs, ms_per_span={p: min(v) / n * 1e3
                                    for p, v in secs.items()},
         edges_per_s={p: edges[p] / min(secs[p]) for p in secs},
         peak_mem_bytes=peak, resident_mem_bytes=resident,
         profiles=profiles, aten_calls_first_span=calls,
         events_fp32=len(ev32), events_bf16=len(ev16), event_jaccard=jaccard,
         events_only_fp32=sorted(ev32 - ev16),
         events_only_bf16=sorted(ev16 - ev32),
         live_grains={"fp32": int(final32.mask_g.sum()),
                      "bf16": int(final.mask_g.sum())},
         capacity={f: int(aux[f].sum()) for f in
                   ("ring_overflow", "pp_overflow", "elim_saturated")})

    span = bf16_span_card_vs_cpu(reg, cls, reg_cpu, cls_cpu, state)
    cfg = BATCHED
    singles = []
    for seed in cfg["seeds"][:BF16["lanes"]]:
        t = dd.generate_trajectory(cfg["lxd"], seed, cfg["G"], cfg["R"])
        singles.append(dd.init_scaled_state(t.x, t.edges, t.mask, t.lxd,
                                            t.patch_size, device=dev)[0])
    stacked = dr.stack_states(singles)
    lanes = lanes_vs_singles(reg, cls, stacked, singles, BF16["lane_spans"],
                             pallas=True)
    if lanes["lanes_equal"] < 1:
        raise RuntimeError(f"bf16 batched: no lane equals its single run "
                           f"({lanes})")
    reset_launches()
    _, baux = dr.make_rollout_batched(reg, cls, n_steps=BF16["lane_spans"],
                                      c_threshold=C_THRESHOLD,
                                      pallas=True)(stacked)
    torch.cuda.synchronize()
    blaunch = (dict(edge_stage.launches), dict(edge_stage.bf16_launches))
    nb = BF16["lane_spans"]
    if blaunch != ({"node_proj": 0, "edge_attn": 0},
                   {"node_proj": 12 * nb, "edge_attn": 12 * nb}) or (
                       cell_update.launches != 4 * nb):
        raise RuntimeError(f"bf16 batched: launches {blaunch}, "
                           f"{cell_update.launches} of the cells' update")
    emit(phase="bf16_span", span=span, batched=dict(
        lanes, B=len(singles), launches_fp32=blaunch[0],
        launches_bf16=blaunch[1], switches=int(
            (baux["switching"][..., 0] >= 0).sum())))

    sample, _ = dr.make_sample(state)
    rows = bf16_kernel_rows(decoder_conv_inputs(reg, sample, "bf16"),
                            reg.hp.layer_size)
    kernel_rows = [dict(row, launches=launches["by_shape"].get(key, 0))
                   for key, row in rows.items()]

    reset_launches()
    with Recorder(capture=False) as rec:
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            cli.main(GEN40 + ["--pallas"])
    torch.cuda.synchronize()
    line = json.loads(out.getvalue().strip().splitlines()[-1])
    cli_launch = (dict(edge_stage.launches), dict(edge_stage.bf16_launches))
    if (any(cli_launch[0].values())
            or cli_launch[1] != {"node_proj": 12 * rec.spans,
                                 "edge_attn": 12 * rec.spans}
            or cell_update.launches != 4 * rec.spans
            or "events_pred" not in line):
        raise RuntimeError(f"cli --pallas: {line}, launches {cli_launch}, "
                           f"{cell_update.launches} of the cells' update")
    err = io.StringIO()
    refused = ["--generate", "--device_resident", "--model_dir",
               "artifacts/40um", "--seed", "3", "--G", "4", "--R", "1",
               "--pallas", "--partition", "4"]
    try:
        with contextlib.redirect_stderr(err):
            cli.main(refused)
        raise RuntimeError("cli: --pallas --partition 4 was not refused")
    except SystemExit:
        if "--pallas applies to the single-device scan" not in err.getvalue():
            raise RuntimeError(f"cli: refused for {err.getvalue()!r}")
    emit(phase="bf16_cli", cli_args=GEN40 + ["--pallas"], cli=line,
         spans=rec.spans, launches_fp32=cli_launch[0],
         launches_bf16=cli_launch[1], refused=refused,
         refusal=err.getvalue().strip().splitlines()[-1])
    # the kernels at the 40 um graph's decoder convs, launched by the CLI
    cli_shapes = dict(edge_stage.shape_launches)
    t40 = trajs[40]
    st40, _, _ = dd.init_scaled_state(t40.x, t40.edges, t40.mask, t40.lxd,
                                      t40.patch_size, device=dev)
    rows = bf16_kernel_rows(decoder_conv_inputs(
        reg, dr.make_sample(st40)[0], "bf16"), reg.hp.layer_size, "_40um")
    kernel_rows += [dict(row, launches=cli_shapes.get(key, 0))
                    for key, row in rows.items()]

    # a counted bf16 run of the 240 um graph, then the kernels at its
    # decoder convs
    t240 = trajs[R240["lxd"]]
    st240, _, _ = dd.init_scaled_state(t240.x, t240.edges, t240.mask,
                                       t240.lxd, t240.patch_size, device=dev)
    n240 = BF16["spans240"]
    reset_launches()
    _, aux240 = dr.make_rollout(reg, cls, n_steps=n240,
                                c_threshold=C_THRESHOLD,
                                pallas="bf16")(st240)
    torch.cuda.synchronize()
    l240 = counted_launches()
    if (dict(edge_stage.bf16_launches) != {"node_proj": 12 * n240,
                                           "edge_attn": 12 * n240}
            or l240["node_proj"] or l240["edge_attn"]
            or l240["editor"] != n240 or l240["cell_update"] != 4 * n240):
        raise RuntimeError(f"bf16 240 um: launches {l240}, "
                           f"{edge_stage.bf16_launches}")
    emit(phase="bf16_rollout240", spans=n240,
         launches_bf16=dict(edge_stage.bf16_launches), editor=l240["editor"],
         switches=int((aux240["switching"][..., 0] >= 0).sum()))
    rows = bf16_kernel_rows(decoder_conv_inputs(
        reg, dr.make_sample(st240)[0], "bf16"), reg.hp.layer_size, "_240um")
    kernel_rows += [dict(row, launches=l240["by_shape"].get(key, 0))
                    for key, row in rows.items()]
    return kernel_rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="also profile one rollout, the batched rollout and "
                         "train steps by kernel")
    args = ap.parse_args()

    dev, smi = phase_device()
    phase_build()
    cuda = torch.device("cuda")
    reg, _, _ = checkpoint.load_model("artifacts/40um/regressor0", cuda)
    cls, _, _ = checkpoint.load_model("artifacts/40um/classifier1", cuda)
    x, edges, mask, lxd, patch = dd.load_fixture()
    state, _, _ = dd.init_scaled_state(x, edges, mask, lxd, patch, device=cuda)

    # the inference phases: no autograd (the edge stage kernels have none)
    with torch.no_grad():
        launches, editor = phase_rollout(reg, cls, state, N_SPANS)
        conv_rows = phase_edge_stage(reg, state)
        update_row = cell_update_row(reg, dr.make_sample(state)[0],
                                     launches["cell_update"])
        editor_row = phase_editor(reg, cls, state)
        if args.profile:
            phase_profile(reg, cls, state, N_SPANS)
        reg_cpu, _, _ = checkpoint.load_model("artifacts/40um/regressor0",
                                              "cpu")
        cls_cpu, _, _ = checkpoint.load_model("artifacts/40um/classifier1",
                                              "cpu")
        phase_reference(reg, cls, state, reg_cpu, cls_cpu)
        trajs = phase_generator()
        bf16_rows = phase_bf16(reg, cls, reg_cpu, cls_cpu, state, cuda,
                               trajs)
        generate_row = phase_generate(reg, cls, reg_cpu, cls_cpu, cuda)
        gen40_rows = phase_generate40(trajs[40], reg, cls, reg_cpu, cls_cpu,
                                      cuda)
        r240_rows = phase_rollout240(trajs[R240["lxd"]], reg, cls, reg_cpu,
                                     cls_cpu, cuda)
        batched_rows = phase_batched(reg, cls, reg_cpu, cls_cpu, cuda,
                                     profile=args.profile)
        engine_rows = phase_engine(reg, cls, cuda)
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_train_",
                                     dir=here) as workdir:
        train_rows = phase_train(state, smi, workdir, profile=args.profile)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_pf_",
                                     dir=here) as workdir:
        pf_rows, pf, pf_line = phase_pf(reg, cls, cuda, smi, workdir)
        with torch.no_grad():
            partition_rows = phase_partition(reg, cls, cuda, smi, workdir,
                                             trajs[R240["lxd"]], pf, pf_line)
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_dist_",
                                     dir=here) as workdir:
        dist_rows = phase_dist_train(reg, cuda, smi, workdir)

    kernels = [dict(row, launches=launches["by_shape"].get(key, 0))
               for key, row in conv_rows.items()]
    bound_ms, bound_by = editor["bound"]
    kernels.append(dict(
        editor_row, ms=editor["ms"], plain_ms=editor["plain_ms"],
        max_abs_err=max(editor_row["max_abs_err"], editor["max_abs_err"]),
        check=f"{editor_row['check']} and {editor['checked_spans']} "
              "rollout spans",
        bound_ms=bound_ms, bound_by=bound_by, launches=launches["editor"]))
    kernels.append(update_row)
    kernels.append(generate_row)
    kernels += bf16_rows + gen40_rows + r240_rows + batched_rows + engine_rows
    kernels += list(train_rows.values()) + pf_rows + partition_rows
    kernels += dist_rows
    for k in kernels:
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms"):
            if not math.isfinite(k[key]):
                raise RuntimeError(f"{k['name']}: {key} = {k[key]}")
        if k["launches"] < 1:
            raise RuntimeError(f"{k['name']}: not launched on the main path")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": dev}), flush=True)


if __name__ == "__main__":
    main()
