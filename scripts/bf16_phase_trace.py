"""Where the time goes inside one block of the bf16 edge kernels, on one
card: csrc/edge_stage_bf16.cu is copied with its TRACE_STAMP / TRACE_END
markers defined to write %globaltimer on thread 0 of each block
(node_proj_bf16: start, barriers initialised, first x tile landed, its A
fragments loaded, W landed, end; edge_attn_bf16: start, slot tables
written, q landed, the rows, the block barrier, the Wl2 wait, the l2
product, the epilogue's wait, end, and six points inside the first row
of warp 0), built with nvcc beside the real build, and run once after a
warm-up at the decoder convs of the 40 and 120 um graphs. The stamped
copy is slower than the real kernel (the stamps take registers): read
phases against each other, and the real kernel's times from
chip_smoke.py.

    python3 scripts/bf16_phase_trace.py [-DEB_ROWS=16 -DEB_BLOCK_WARPS=8 ...]

Extra arguments go to nvcc (EB_ROWS and EB_BLOCK_WARPS set
edge_attn_bf16's rows and warps a block). Prints one JSON line per
kernel and conv: its ms (chip_smoke.cuda_ms), the blocks, the spread of
their starts, the latest end, and the median and largest time of each
phase in microseconds; each edge_attn_bf16 output is first held to its
plain bf16 version (chip_smoke.close_bf16).
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from graingraphnn_torch.kernels import _build, edge_stage  # noqa: E402
from graingraphnn_torch.rollout import device_driver as dd  # noqa: E402
from graingraphnn_torch.rollout import device_rollout as dr  # noqa: E402
from graingraphnn_torch.train import checkpoint  # noqa: E402

HEAD = r"""
__device__ unsigned long long g_trace[2][4096][16];
__device__ __forceinline__ unsigned long long gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define TRACE_STAMP(k, i, on) do { if ((on) && threadIdx.x == 0 && \
  (blockIdx.x + blockIdx.y * gridDim.x) < 4096) \
  g_trace[k][blockIdx.x + blockIdx.y * gridDim.x][i] = gtime(); } while (0)
#define TRACE_END(k, i) do { __syncthreads(); TRACE_STAMP(k, i, true); } while (0)
"""
ENTRIES = r"""
extern "C" {
int trace_read(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_trace, sizeof(g_trace));
}
int trace_clear() {
  static unsigned long long z[2][4096][16];
  return (int)cudaMemcpyToSymbol(g_trace, z, sizeof(z));
}
}
"""
# the points read: kernel 0 node_proj_bf16, 1 edge_attn_bf16 (10-15 inside
# the first row of warp 0)
POINTS = {0: list(range(6)), 1: list(range(9)) + list(range(10, 16))}


def stamped_source():
    """csrc/edge_stage_bf16.cu with its markers defined; raises if a point
    read here has no marker in the source."""
    with open(os.path.join(_build.CSRC, edge_stage.SOURCE_BF16 + ".cu")) as f:
        s = f.read()
    for k, points in POINTS.items():
        for i in points:
            if not re.search(rf"TRACE_(STAMP|END)\({k}, {i}[,)]", s):
                raise RuntimeError(f"bf16_phase_trace: no marker ({k}, {i})")
    return HEAD + s + ENTRIES


def build(flags):
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    src = os.path.join(_build.BUILD_DIR, "edge_stage_bf16_trace.cu")
    with open(src, "w") as f:
        f.write(stamped_source())
    so = os.path.join(_build.BUILD_DIR, "libedge_stage_bf16_trace.so")
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", _build.CSRC,
                    *flags, "-o", so, src], check=True, capture_output=True,
                   text=True)
    lib = ctypes.CDLL(so)
    fns = {}
    for which, sym in edge_stage.ENTRIES["bf16"][1].items():
        fn = getattr(lib, sym)
        fn.argtypes = edge_stage.ARGTYPES["bf16"][which]
        fn.restype = ctypes.c_int
        fns[which] = fn
    lib.trace_read.argtypes = [ctypes.c_void_p]
    return lib, fns


def main():
    flags = sys.argv[1:]
    cs.phase_device()
    lib, fns = build(flags)
    buf = np.zeros((2, 4096, 16), np.uint64)
    dev = torch.device("cuda")
    reg, _, _ = checkpoint.load_model("artifacts/40um/regressor0", dev)
    x, edges, mask, lxd, patch = dd.load_fixture()
    states = {120: dd.init_scaled_state(x, edges, mask, lxd, patch,
                                        device=dev)[0]}
    t = dd.generate_trajectory(40, 3, 4.0, 1.0)
    states[40] = dd.init_scaled_state(t.x, t.edges, t.mask, t.lxd,
                                      t.patch_size, device=dev)[0]
    G, C = 4, reg.hp.layer_size
    kw = dict(num_gates=G, out_channels=C, precision="bf16")
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    with torch.no_grad():
        for lx in (40, 120):
            sample, _ = dr.make_sample(states[lx])
            for name, (conv, xs, xd, nbr, ln, m) in cs.decoder_conv_inputs(
                    reg, sample, "bf16").items():
                proj = edge_stage.node_proj_cuda(conv, xs, xd, "bf16")
                calls = {
                    "node_proj": lambda: edge_stage.launch_node_proj(
                        fns["node_proj"], stream(), conv, xs, xd, "bf16"),
                    "edge_attn": lambda: edge_stage.launch_edge_attn(
                        fns["edge_attn"], stream(), conv, xs, xd, nbr, ln, m,
                        proj, G, C, "bf16")}
                cs.close_bf16("stamped edge_attn_bf16", calls["edge_attn"](),
                              cs.period_conv.edge_attn_plain(
                                  conv, xs, xd, nbr, ln, m, proj, **kw))
                for k, (kernel, fn) in enumerate(calls.items()):
                    ms = cs.cuda_ms(fn)
                    lib.trace_clear()
                    torch.cuda.synchronize()
                    fn()
                    torch.cuda.synchronize()
                    lib.trace_read(buf.ctypes.data)
                    tr = buf[k].astype(np.int64)
                    tr = tr[tr[:, 0] > 0]
                    pts = 6 if k == 0 else 9
                    rel = (tr[:, :pts] - tr[:, 0].min()) / 1e3
                    d = np.diff(tr[:, :pts], axis=1) / 1e3
                    row = {}
                    if k == 1:
                        row = dict(
                            first_row_start_us=float(np.median(
                                tr[:, 10] - tr[:, 0]) / 1e3),
                            first_row_phase_med_us=[round(float(v), 3) for v in
                                np.median(np.diff(tr[:, 10:16], axis=1), 0) / 1e3])
                    print(json.dumps(dict(
                        lxd=lx, conv=name, kernel=kernel, flags=flags, ms=ms,
                        blocks=len(tr), start_spread_us=float(rel[:, 0].max()),
                        end_max_us=float(rel[:, pts - 1].max()),
                        phase_med_us=[round(float(v), 3) for v in np.median(d, 0)],
                        phase_max_us=[round(float(v), 3) for v in d.max(0)],
                        **row)), flush=True)


if __name__ == "__main__":
    main()
