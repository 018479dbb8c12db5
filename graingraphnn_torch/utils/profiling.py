"""Profiling and roofline accounting.

  * `trace(logdir)`: a context manager around torch.profiler (CPU, and the
    card's kernels where there is one) that writes a Chrome trace to
    logdir/trace.json (chrome://tracing, Perfetto);
  * analytic operation and byte counts of the fused periodic conv and of
    the whole GrainNN forward, the JAX package's arithmetic;
  * `roofline(time_s, flops, bytes_)`: the achieved share of the compute
    and bandwidth peaks of a ChipSpec;
  * `slope_time` and `timeit`: seconds per call, on CUDA events for a
    card's work (host clock on the CPU).

`ChipSpec.h100()` holds the NVIDIA H100 SXM datasheet peaks that
chip_smoke.py's bounds use; they are datasheet figures, not measurements,
and a card run below its 700 W limit reaches less.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict

import torch

# NVIDIA H100 SXM datasheet peaks (chip_smoke.py's bounds use these)
H100_PEAK_FP32 = 67e12          # fp32 outside the tensor cores, FLOP/s
H100_PEAK_TF32X3 = 495e12 / 3   # TF32 tensor cores, 3 products per fp32 one
H100_PEAK_BF16 = 989e12         # bf16 tensor cores, dense, FLOP/s
H100_PEAK_BYTES = 3.35e12       # HBM3, bytes/s


@dataclasses.dataclass
class ChipSpec:
    name: str
    peak_flops: float     # FLOP/s at the counted dtype
    hbm_bw: float         # bytes/s

    @classmethod
    def h100(cls, kind: str = "fp32") -> "ChipSpec":
        """The H100 SXM's datasheet peaks: kind "fp32" (CUDA cores) or
        "tf32x3" (fp32 products as three TF32 tensor-core products)."""
        peak = {"fp32": H100_PEAK_FP32, "tf32x3": H100_PEAK_TF32X3}[kind]
        return cls(f"NVIDIA H100 SXM {kind} (datasheet peak)", peak,
                   H100_PEAK_BYTES)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with torch.profiler (the card's activity too when
    CUDA is available); on exit write logdir/trace.json. Yields the
    profiler (key_averages() for a table)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def conv_cost(ns: int, nd: int, k: int, f_src: int, f_dst: int,
              gates: int, channels: int, dtype_bytes: int = 4) -> Dict[str, float]:
    """FLOPs and bytes of one fused periodic-conv application
    (ops.period_conv.apply_period_conv)."""
    gc = gates * channels
    flops = 0.0
    # node-level projections: key, value (src), query, skip (dst), Pk, Pv
    flops += 2 * ns * f_src * gc * 2
    flops += 2 * nd * f_dst * gc * 2
    flops += 2 * nd * 3 * gc * 2
    # edge stage: shift correction, value MLP (block-diag), logits, softmax
    flops += 2 * nd * k * 3 * gc * 2          # shift @ W
    flops += 2 * nd * k * gc * channels       # l2 matmul per gate block
    flops += nd * k * gc * 3                  # logits product+sum, alpha mult
    flops += nd * k * gates * 6               # softmax

    bytes_ = 0.0
    bytes_ += (ns * f_src + nd * f_dst) * dtype_bytes          # node features
    bytes_ += 2 * nd * k * gc * dtype_bytes                    # gathered K,V
    bytes_ += (f_src + f_dst + gc) * gc * dtype_bytes          # weights
    bytes_ += nd * gc * dtype_bytes                            # output
    return {"flops": flops, "bytes": bytes_}


def model_forward_cost(ng: int, nj: int, ring: int, f_grain: int, f_joint: int,
                       channels: int, layers: int = 1) -> Dict[str, float]:
    """One GrainNN encoder+decoder forward (2 stacks x a fused cell of 3
    conv applications; `layers` is not counted, as in the JAX package)."""
    fg = f_grain + channels
    fj = f_joint + channels
    total = {"flops": 0.0, "bytes": 0.0}
    for _ in range(2):  # encoder + decoder
        for c in (
            conv_cost(ng, nj, 3, fg, fj, 4, channels),    # push
            conv_cost(nj, nj, 3, fj, fj, 4, channels),    # connect
            conv_cost(nj, ng, ring, fj, fg, 4, channels),  # pull
        ):
            total["flops"] += c["flops"]
            total["bytes"] += c["bytes"]
    return total


def roofline(time_s: float, flops: float, bytes_: float,
             spec: ChipSpec | None = None) -> Dict[str, float]:
    """Achieved rates and their shares of spec's peaks (default: the
    H100's fp32 datasheet peaks)."""
    spec = spec or ChipSpec.h100()
    return {
        "chip": spec.name,
        "achieved_tflops": flops / time_s / 1e12,
        "compute_fraction": flops / time_s / spec.peak_flops,
        "achieved_gbps": bytes_ / time_s / 1e9,
        "bandwidth_fraction": bytes_ / time_s / spec.hbm_bw,
        "arithmetic_intensity": flops / max(bytes_, 1.0),
        "ridge_intensity": spec.peak_flops / spec.hbm_bw,
    }


class _Clock:
    """Elapsed seconds between start() and stop(): CUDA events on a card
    (the device's time for the work issued between them), the host clock
    on the CPU."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"

    def start(self):
        if self.cuda:
            self.e0, self.e1 = (torch.cuda.Event(enable_timing=True)
                                for _ in range(2))
            torch.cuda.synchronize()
            self.e0.record()
        else:
            self.t0 = time.perf_counter()

    def stop(self) -> float:
        if self.cuda:
            self.e1.record()
            self.e1.synchronize()
            return self.e0.elapsed_time(self.e1) / 1e3
        return time.perf_counter() - self.t0


def slope_time(f, n1: int = 100, n2: int = 900, reps: int = 3,
               device: str = "cuda") -> float:
    """Seconds per iteration of `f` (tensor carry -> carry), the slope
    between runs of n1 and n2 iterations: a fixed cost per run (the
    launch of the first kernel, the final synchronisation) cancels.
    Minimum over reps."""
    clock = _Clock(device)
    x0 = torch.ones((), device=device)

    def run(n):
        clock.start()
        c = x0
        for _ in range(n):
            c = f(c)
        return clock.stop()

    run(n1)
    ts = []
    for _ in range(reps):
        t1 = run(n1)
        t2 = run(n2)
        ts.append((t2 - t1) / (n2 - n1))
    return min(ts)


def timeit(fn, *args, iters: int = 50, device: str = "cuda") -> float:
    """Steady-state seconds per call of fn(*args) after one warm-up call,
    on CUDA events (or the host clock for device="cpu")."""
    clock = _Clock(device)
    fn(*args)
    clock.start()
    for _ in range(iters):
        fn(*args)
    return clock.stop() / iters
