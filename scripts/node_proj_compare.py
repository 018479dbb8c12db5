"""The fp32 node projections (node_proj, csrc/edge_stage.cu) of this
checkout against those of another checkout (an earlier commit unpacked with
`git archive`) and against the library pair, on one card, in turns.

    python3 scripts/node_proj_compare.py --other DIR [--other DIR2 ...] [--repeats 2]
        [--flag=-DNP_KCHUNK=4 ...] [--cells fp32-hex64x120,fp32-hex8x240]
        [--no-single]

DIR is the root of the other checkout (named by its last path part; the
first one named is timed in turns with this checkout, the rest after
them). Its csrc/edge_stage.cu is built
here with nvcc and launched through its own kernels/edge_stage.py (its
argument lists and launch_node_proj), so the two may differ in how they
take the weights. Shapes:
  - each benchmark cell's convs (portbench's traffic at seed 0: the 12
    conv calls of the first span of one build, caught where the models
    call models.cells.apply_period_conv), each distinct shape once, and
    the span's 12 launches together;
  - the decoder convs of the 40, 120 and 240 um single-lane graphs (as
    chip_smoke's kernel rows), with the shipped 40 um regressor;
  - the halo stripe 0 (D = 4) and partitioned (rank 0, D = 4) convs of
    the 120 um graph by their row counts (PERF.md's kernel table), on
    random rows of the decoder's widths.
Each build (but those that leave a part out, -DNODE_PROJ_PART) is checked
against period_conv.node_projections_plain (within chip_smoke's ATOL and
RTOL; this checkout's raises past them, another's reports it) and timed with chip_smoke.cuda_ms in the order
other, this, this, other, `--repeats` rounds, with the library pair (two
torch.addmm, TF32 off) and the bound of chip_smoke.node_proj_cost beside
them; this checkout's grid branch (edge_stage.node_proj_branches) per
shape; each extra build of this source (`--flag`, one build per flag)
timed after this one. Prints the card's name and power limit, the builds'
ptxas lines, then one JSON line per shape.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke as cs  # noqa: E402
from graingraphnn_torch.kernels import _build, edge_stage  # noqa: E402
from graingraphnn_torch.ops import period_conv  # noqa: E402
from graingraphnn_torch.rollout import device_driver as dd  # noqa: E402
from graingraphnn_torch.rollout import device_rollout as dr  # noqa: E402
from graingraphnn_torch.train import checkpoint  # noqa: E402

GRAPHS = {40: (3, 4.0, 1.0), 240: (cs.R240["seed"], cs.R240["G"],
                                   cs.R240["R"])}
# (Ns, Nd) of the 120 um decoder convs push, connect, pull on halo stripe 0
# and on rank 0 of the partitioned forward, D = 4 (PERF.md's kernel table)
ROWS = {"halo": ((1248, 816), (2448, 816), (2448, 416)),
        "partition": ((1044, 522), (2088, 522), (2088, 261))}


def build_other(root):
    """The other checkout's launch_node_proj and its fp32 node_proj entry,
    bound by its own argument list, and its ptxas lines."""
    path = os.path.join(root, "graingraphnn_torch", "kernels", "edge_stage.py")
    spec = importlib.util.spec_from_file_location(
        "graingraphnn_torch.kernels._other_edge_stage_"
        + os.path.basename(os.path.normpath(root)), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    src = os.path.join(root, "graingraphnn_torch", "csrc", "edge_stage.cu")
    with open(src, "rb") as f:
        tag = hashlib.sha256(f.read()).hexdigest()[:12]
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    out = os.path.join(_build.BUILD_DIR, f"libother_edge_stage-{tag}.so")
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
                          capture_output=True, text=True, check=True)
    lib = ctypes.CDLL(out)
    fn = lib.edge_node_proj
    fn.argtypes, fn.restype = mod._PROJ_ARGTYPES, ctypes.c_int

    def call(*a):
        err = fn(*a)
        if err:
            raise RuntimeError(f"other edge_node_proj: cudaError {err}")

    return mod.launch_node_proj, call, _ptxas(proc.stdout + proc.stderr)


def _ptxas(text):
    return [ln.strip() for ln in text.splitlines()
            if "ptxas" in ln or "warning" in ln.lower()]


def cell_convs(cell_name, dev):
    """{name: (conv, x_src, x_dst)} of the distinct conv shapes of the
    first span of one build of the cell, and the span's 12 calls in
    order."""
    from portbench import spec, system
    from portbench import traffic as traffic_mod

    cell = spec.cell(cell_name)
    program = system.Program(cell.config, cell.traffic, dev)
    graphs = traffic_mod.lane_graphs(cell.traffic, 0)
    start, _ = traffic_mod.starting_state(graphs, dev)
    calls = []

    def make(original):
        def caught(conv, x_src, x_dst, *args, **kwargs):
            if len(calls) < 12:
                calls.append((conv, x_src.clone(), x_dst.clone()))
            return original(conv, x_src, x_dst, *args, **kwargs)
        return caught

    with system.patched("graingraphnn_torch.models.cells",
                        "apply_period_conv", make):
        program.run(start)
    shapes = {}
    for conv, xs, xd in calls:
        name = f"{xs.shape[0]}x{xs.shape[1]}->{xd.shape[0]}x{xd.shape[1]}"
        shapes.setdefault(name, (conv, xs, xd))
    return shapes, calls


def single_lane_convs(reg, dev):
    """{name: (conv, x_src, x_dst)}: the decoder convs of the 40, 120 and
    240 um graphs' first span, and the halo and partitioned row counts."""
    x, edges, mask, lxd, patch = dd.load_fixture()
    states = {120: dd.init_scaled_state(x, edges, mask, lxd, patch,
                                        device=dev)[0]}
    for lxd, (seed, G, R) in GRAPHS.items():
        t = dd.generate_trajectory(lxd, seed, G, R)
        states[lxd] = dd.init_scaled_state(t.x, t.edges, t.mask, t.lxd,
                                           t.patch_size, device=dev)[0]
    out = {}
    for lxd in sorted(states):
        sample, _ = dr.make_sample(states[lxd])
        for name, (conv, xs, xd, *_) in cs.decoder_conv_inputs(
                reg, sample).items():
            out[f"{lxd}um_{name}"] = (conv, xs, xd)
    gen = torch.Generator(device=dev).manual_seed(0)
    for part, rows in ROWS.items():
        for name, (Ns, Nd) in zip(("push", "connect", "pull"), rows):
            conv, xs, xd = out[f"120um_{name}"]
            out[f"{part}_{name}"] = (
                conv, torch.rand(Ns, xs.shape[1], generator=gen, device=dev),
                torch.rand(Nd, xd.shape[1], generator=gen, device=dev))
    return out


def timed(calls, repeats):
    """{who: [ms, ...]} of each call in the turns other, this, this,
    other (other the first of the others), then the rest in order,
    `repeats` rounds."""
    first = next(iter(calls))
    order = [first, "this", "this", first] + [
        k for k in calls if k not in (first, "this")]
    ms = {k: [] for k in calls}
    for _ in range(repeats):
        for who in order:
            ms[who].append(cs.cuda_ms(calls[who]))
    return ms


def compare(name, conv, xs, xd, others, extra, repeats):
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    w_src = torch.cat([conv.key.w, conv.value.w], 1)
    b_src = torch.cat([conv.key.b, conv.value.b])
    w_dst = torch.cat([conv.query.w, conv.skip.w], 1)
    b_dst = torch.cat([conv.query.b, conv.skip.b])
    calls = {
        **{who: (lambda f=f, fn=fn: f(fn, stream(), conv, xs, xd))
           for who, (f, fn) in others.items()},
        "this": lambda: edge_stage.node_proj_cuda(conv, xs, xd),
        "library": lambda: (torch.addmm(b_src, xs, w_src),
                            torch.addmm(b_dst, xd, w_dst)),
        **{flag: (lambda fn=fn: edge_stage.launch_node_proj(
            fn, stream(), conv, xs, xd)) for flag, fn in extra.items()},
    }
    ref = period_conv.node_projections_plain(conv, xs, xd)
    err = {}
    for who, fn in calls.items():
        if who == "library" or "PART" in who:     # parts compute nothing of use
            continue
        edge_stage.reset_counts()
        out = fn()
        if who == "this":
            branches = dict(edge_stage.node_proj_branches)
        try:
            err[who] = max(cs.close(f"node_proj {name} {who}", o, r)[0]
                           for o, r in zip(out, ref))
        except RuntimeError as e:       # this checkout's build must pass
            if who == "this":
                raise
            err[who] = str(e)
    ms = timed(calls, repeats)
    flops, bytes_ = cs.node_proj_cost(xs, xd, conv.key.w.shape[1])
    bound, by = cs.bound(bytes_, (flops, cs.PEAK_TF32X3))
    print(json.dumps(dict(
        shape=name, Ns=xs.shape[0], Nd=xd.shape[0], F_src=xs.shape[1],
        F_dst=xd.shape[1], branch=branches, max_abs_err=err, ms=ms,
        ms_min={k: min(v) for k, v in ms.items()}, bound_ms=bound,
        bound_by=by)), flush=True)


def span_compare(cell, calls, others, repeats):
    """The span's 12 node_proj launches together, each side."""
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    fns = {
        **{who: (lambda f=f, fn=fn: [f(fn, stream(), c, xs, xd)
                                     for c, xs, xd in calls])
           for who, (f, fn) in others.items()},
        "this": lambda: [edge_stage.node_proj_cuda(c, xs, xd)
                         for c, xs, xd in calls],
    }
    edge_stage.reset_counts()
    fns["this"]()
    branches = dict(edge_stage.node_proj_branches)
    ms = timed(fns, repeats)
    bound = 0.0
    for c, xs, xd in calls:
        flops, bytes_ = cs.node_proj_cost(xs, xd, c.key.w.shape[1])
        bound += cs.bound(bytes_, (flops, cs.PEAK_TF32X3))[0]
    print(json.dumps(dict(cell=cell, span_launches=len(calls),
                          branch=branches, ms=ms,
                          ms_min={k: min(v) for k, v in ms.items()},
                          bound_ms=bound)), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--other", action="append", required=True)
    ap.add_argument("--repeats", type=int, default=2)
    ap.add_argument("--flag", action="append", default=[], dest="flags")
    ap.add_argument("--cells", default="fp32-hex64x120,fp32-hex8x240")
    ap.add_argument("--no-single", action="store_true",
                    help="only the cells' shapes")
    args = ap.parse_args()
    cs.phase_device()
    dev = torch.device("cuda")
    specs = [(edge_stage.SOURCE, edge_stage.NVCC_FLAGS)] + [
        (edge_stage.SOURCE, edge_stage.NVCC_FLAGS + (f,)) for f in args.flags]
    log = _build.build(specs)
    others, ptxas = {}, {}
    for root in args.other:
        who = os.path.basename(os.path.normpath(root))
        launch, fn, ptxas[who] = build_other(root)
        others[who] = (launch, fn)
    print(json.dumps({"ptxas_this": {k: v["ptxas"] for k, v in log.items()},
                      "ptxas_other": ptxas}), flush=True)
    extra = {f: _build.function(edge_stage.SOURCE, "edge_node_proj",
                                edge_stage._PROJ_ARGTYPES,
                                edge_stage.NVCC_FLAGS + (f,))
             for f in args.flags}
    with torch.no_grad():
        reg, _, _ = checkpoint.load_model("artifacts/40um/regressor0", dev)
        single = {} if args.no_single else single_lane_convs(reg, dev)
        for name, (conv, xs, xd) in single.items():
            compare(name, conv, xs, xd, others, extra, args.repeats)
        for cell in filter(None, args.cells.split(",")):
            shapes, calls = cell_convs(cell, dev)
            for name, (conv, xs, xd) in shapes.items():
                compare(f"{cell}_{name}", conv, xs, xd, others, extra,
                        args.repeats)
            span_compare(cell, calls, others, args.repeats)
            del shapes, calls
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
