"""Where the time goes inside the blocks of the fp32 edge kernel, on one
card: csrc/edge_stage.cu is copied with its EA_STAMP markers defined to
write %globaltimer on lane 0 of the marking warp (0 block start, all
mbarriers set; 1 the first tile's slot table written, table warp 0; 2 Wl2
landed, product warp 0; 3 the first tile's sums in, product warp 0; 4
its products and outputs done; 5 gather warp 0's items of the first tile
done; 6 product warp 0's last tile done), built with nvcc beside the real
build, and run once after a warm-up at the decoder convs of the 40 and
120 um graphs and of 8 packed training windows, and at the benchmark cell's
push conv (the first 4096 blocks). The stamped copy is a little slower
than the real kernel: read phases against each other, and the real
kernel's times from scripts/edge_attn_compare.py.

    python3 scripts/edge_attn_phase_trace.py [--cell fp32-hex64x120] [-DEA_GW=20 ...]

Other arguments go to nvcc. Prints the card's name and power limit, then
one JSON line per conv: its ms (chip_smoke.cuda_ms), the blocks, the
spread of their starts, the latest end, and the median and largest time
of each point after its block's start, in microseconds; each output is
first held to its plain version (chip_smoke.close).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke as cs  # noqa: E402
import edge_attn_compare as eac  # noqa: E402
from graingraphnn_torch.kernels import _build, edge_stage  # noqa: E402
from graingraphnn_torch.ops import period_conv  # noqa: E402
from graingraphnn_torch.train import checkpoint  # noqa: E402

POINTS = 7
HEAD = r"""
__device__ unsigned long long g_trace[4096][8];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define EA_STAMP(i, on) do { if ((on) && (threadIdx.x & 31) == 0 && \
  blockIdx.x < 4096) g_trace[blockIdx.x][i] = gtime(); } while (0)
"""
ENTRIES = r"""
extern "C" {
int trace_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace));
}
int trace_clear() {
  static unsigned long long z[4096][8];
  return (int)cudaMemcpyToSymbol(g_trace, z, sizeof(z));
}
}
"""


def build(flags):
    """The stamped copy's edge_attn entry and its trace reader."""
    with open(os.path.join(_build.CSRC, edge_stage.SOURCE + ".cu")) as f:
        src = f.read()
    for i in range(POINTS):
        if f"EA_STAMP({i}," not in src:
            raise RuntimeError(f"edge_attn_phase_trace: no marker {i}")
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    path = os.path.join(_build.BUILD_DIR, "edge_stage_trace.cu")
    with open(path, "w") as f:
        f.write(HEAD + src + ENTRIES)
    so = os.path.join(_build.BUILD_DIR, "libedge_stage_trace.so")
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC,
                    *flags, "-o", so, path], check=True, capture_output=True,
                   text=True)
    lib = ctypes.CDLL(so)
    fn = lib.edge_attn_forward
    fn.argtypes, fn.restype = edge_stage._ATTN_ARGTYPES, ctypes.c_int
    lib.trace_read.argtypes = [ctypes.c_void_p]
    return lib, fn


def trace(lib, fn, name, inputs):
    conv, xs, xd, nbr, ln, m = inputs
    kw = eac.gates(conv)
    proj = period_conv.node_projections_plain(conv, xs, xd)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    def call():
        return edge_stage.launch_edge_attn(fn, stream(), conv, xs, xd, nbr, ln,
                                           m, proj, kw["num_gates"],
                                           kw["out_channels"])

    cs.close(f"stamped edge_attn {name}", call(), period_conv.edge_attn_plain(
        conv, xs, xd, nbr, ln, m, proj, **kw))
    ms = cs.cuda_ms(call)
    buf = np.zeros((4096, 8), np.uint64)
    lib.trace_clear()
    torch.cuda.synchronize()
    call()
    torch.cuda.synchronize()
    lib.trace_read(buf.ctypes.data)
    tr = buf.astype(np.int64)[:, :POINTS]
    tr = tr[tr[:, 0] > 0]
    rel = np.where(tr > 0, tr - tr[:, :1], 0) / 1e3
    print(json.dumps(dict(
        conv=name, K=nbr.shape[1], ms=ms, blocks=len(tr),
        start_spread_us=float((tr[:, 0].max() - tr[:, 0].min()) / 1e3),
        end_max_us=float((tr[:, 6].max() - tr[:, 0].min()) / 1e3),
        point_med_us=[round(float(v), 3) for v in np.median(rel, 0)],
        point_max_us=[round(float(v), 3) for v in rel.max(0)])), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default="fp32-hex64x120")
    args, flags = ap.parse_known_args()
    cs.phase_device()
    lib, fn = build(flags)
    dev = torch.device("cuda")
    with torch.no_grad():
        reg, _, _ = checkpoint.load_model("artifacts/40um/regressor0", dev)
        cls, _, _ = checkpoint.load_model("artifacts/40um/classifier1", dev)
        single = eac.single_lane_convs(reg, cls, dev)
        for name in ("40um_push", "120um_push", "120um_pull", "train8_push",
                     "halo_push", "engine_K32"):
            trace(lib, fn, name, single[name])
        shapes, _ = eac.cell_convs(args.cell, dev)
        for name, inputs in shapes.items():
            trace(lib, fn, f"{args.cell}_{name}", inputs)


if __name__ == "__main__":
    main()
