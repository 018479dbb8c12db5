"""The fp32 edge kernel (edge_attn, csrc/edge_stage.cu) of this checkout
against that of another checkout (an earlier commit unpacked with
`git archive`), on one card, in turns.

    python3 scripts/edge_attn_compare.py --other DIR [--other DIR2 ...] [--repeats 2]
        [--flag=-DEA_GW=12 ...] [--cells fp32-hex64x120,fp32-hex8x240]
        [--no-single | --single 120um_push,engine_K24,...]

DIR is the root of the other checkout (named by its last path part; the
first one named is timed in turns with this checkout, the rest after
them). Its csrc/edge_stage.cu is built here with nvcc and launched through
its own kernels/edge_stage.py (its argument lists and launch_edge_attn).
Shapes, each kernel on the plain node projections
(period_conv.node_projections_plain) of its conv:
  - each benchmark cell's convs (portbench's traffic at seed 0: the 12
    conv calls of the first span of one build, caught where the models
    call models.cells.apply_period_conv), each distinct shape once, and
    the span's 12 launches together;
  - the decoder convs (the shipped 40 um regressor) of the 40, 120 and
    240 um single-lane graphs, of the 40 um graph at the phase-field
    recipe (pf: seed 10020, G 1.904, R 0.558, the generated graph in place
    of the extracted one), of 8 synthetic 120-grain training windows
    packed (train8), of 8 lanes of 120 um packed (8x120: seeds 5-12), of
    stripe 0 of the 120 um fixture's halo layout at D = 4 (halo) and of
    rank 0's block of the partitioned forward at D = 4 (partition);
  - the 120 um pull conv with its three largest rings forced to 18 / 21 /
    24 and 18 / 26 / 30 slots at rings of 24 and 32 (engine_K24,
    engine_K32), as the host engine's rings grow.
Each build (but those that leave a part out, -DEDGE_ATTN_PART) is checked
against period_conv.edge_attn_plain (within chip_smoke's ATOL and RTOL;
this checkout's raises past them, another's reports it) and timed with
chip_smoke.cuda_ms in the order other, this, this, other, `--repeats`
rounds, with the bound of chip_smoke.edge_attn_cost beside them and this
checkout's grid branch (edge_stage.edge_attn_branches); each extra build
of this source (`--flag`, one build per flag, which may hold several
nvcc flags apart by spaces) timed after them. Prints
the card's name and power limit, the builds' ptxas lines, then one JSON
line per shape.
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
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
import chip_smoke as cs  # noqa: E402
import node_proj_compare as npc  # noqa: E402
from graingraphnn_torch.kernels import _build, edge_stage  # noqa: E402
from graingraphnn_torch.ops import period_conv  # noqa: E402
from graingraphnn_torch.rollout import device_driver as dd  # noqa: E402
from graingraphnn_torch.rollout import device_rollout as dr  # noqa: E402
from graingraphnn_torch.train import checkpoint  # noqa: E402


def gates(conv):
    return dict(num_gates=conv.num_gates, out_channels=conv.out_channels)


def build_other(root):
    """The other checkout's launch_edge_attn and its fp32 edge_attn entry,
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
    fn = ctypes.CDLL(out).edge_attn_forward
    fn.argtypes, fn.restype = mod._ATTN_ARGTYPES, ctypes.c_int

    def call(*a):
        err = fn(*a)
        if err:
            raise RuntimeError(f"other edge_attn_forward: cudaError {err}")

    return mod.launch_edge_attn, call, npc._ptxas(proc.stdout + proc.stderr)


def cell_convs(cell_name, dev):
    """{name: inputs} of the distinct conv shapes of the first span of one
    build of the cell, and the span's 12 calls in order; inputs are
    (conv, x_src, x_dst, nbr, len, mask)."""
    from portbench import spec, system
    from portbench import traffic as traffic_mod

    cell = spec.cell(cell_name)
    program = system.Program(cell.config, cell.traffic, dev)
    graphs = traffic_mod.lane_graphs(cell.traffic, 0)
    start, _ = traffic_mod.starting_state(graphs, dev)
    calls = []

    def make(original):
        def caught(conv, *args, **kwargs):
            if len(calls) < 12:
                calls.append((conv, *[a.clone() for a in args[:5]]))
            return original(conv, *args, **kwargs)
        return caught

    with system.patched("graingraphnn_torch.models.cells",
                        "apply_period_conv", make):
        program.run(start)
    shapes = {}
    for c in calls:
        xs, xd, nbr = c[1], c[2], c[3]
        name = (f"{xs.shape[0]}x{xs.shape[1]}->{xd.shape[0]}x{xd.shape[1]}"
                f"_K{nbr.shape[1]}")
        shapes.setdefault(name, c)
    return shapes, calls


def forced_ring(inputs, K, slots, seed):
    """The pull conv's inputs widened to K slots, the rows of its largest
    rings given live slots (random sources, lengths 0.05-0.3) up to
    `slots` each."""
    conv, xs, xd, nbr, ln, m = inputs
    Nd, K0 = nbr.shape
    pad = lambda t: torch.cat([t, t.new_zeros(Nd, K - K0)], 1)  # noqa: E731
    nbr, ln, m = pad(nbr), pad(ln), pad(m)
    gen = torch.Generator(device=xs.device).manual_seed(seed)
    for row, n in zip(torch.argsort(m.sum(1), descending=True).tolist(), slots):
        live = int(m[row].sum())
        free = (m[row] == 0).nonzero().flatten()[:n - live]
        nbr[row, free] = torch.randint(0, xs.shape[0], (len(free),),
                                       generator=gen, device=xs.device,
                                       dtype=nbr.dtype)
        ln[row, free] = 0.05 + 0.25 * torch.rand(len(free), generator=gen,
                                                  device=xs.device)
        m[row, free] = 1.0
    return conv, xs, xd, nbr.contiguous(), ln.contiguous(), m.contiguous()


def single_lane_convs(reg, cls, dev):
    """{name: inputs} of the one-lane, packed, halo, partitioned and
    engine shapes (module docstring)."""
    from graingraphnn_torch.graph import state as gstate
    from graingraphnn_torch.graph import synthetic

    def scaled(t):
        return dd.init_scaled_state(t.x, t.edges, t.mask, t.lxd, t.patch_size,
                                    device=dev)[0]

    fixture = dd.load_fixture()
    states = {"120um": dd.init_scaled_state(*fixture, device=dev)[0]}
    for name, (lxd, seed, G, R) in {
            "40um": (40, 3, 4.0, 1.0),
            "240um": (240, cs.R240["seed"], cs.R240["G"], cs.R240["R"]),
            "pf": (cs.PF["lxd"], cs.PF["seed"], cs.PF["G"], cs.PF["R"])}.items():
        states[name] = scaled(dd.generate_trajectory(lxd, seed, G, R))
    samples = {k: dr.make_sample(s)[0] for k, s in states.items()}
    samples["8x120"] = dr._pack_build_sample(dr.stack_states([
        scaled(dd.generate_trajectory(120, seed, cs.BATCHED["G"],
                                      cs.BATCHED["R"]))
        for seed in cs.BATCHED["seeds"]]))[0]
    samples["train8"] = gstate.pack(gstate.stack([
        gstate.build_sample(*synthetic.spatial_ring_arrays(120, seed=s),
                            device=dev) for s in range(8)]))
    out = {}
    for key, sample in samples.items():
        for name, inputs in cs.decoder_conv_inputs(reg, sample).items():
            out[f"{key}_{name}"] = inputs
    for name, inputs in cs.stripe_conv_inputs(reg, cls, fixture, 4,
                                              dev).items():
        out[f"halo_{name}"] = inputs
    for name, inputs in cs.gathered_conv_inputs(reg, samples["120um"],
                                                4).items():
        out[f"partition_{name}"] = inputs
    for K, slots in cs.ENGINE_RINGS.items():
        out[f"engine_K{K}"] = forced_ring(out["120um_pull"], K, slots, K)
    return out


def attn_calls(inputs, others, extra):
    """{who: a call of the edge kernel on inputs} for each side, and the
    plain projections and reference."""
    conv, xs, xd, nbr, ln, m = inputs
    proj = period_conv.node_projections_plain(conv, xs, xd)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    kw = gates(conv)
    args = (conv, xs, xd, nbr, ln, m, proj, conv.num_gates, conv.out_channels)
    calls = {
        **{who: (lambda f=f, fn=fn: f(fn, stream(), *args))
           for who, (f, fn) in others.items()},
        "this": lambda: edge_stage.edge_attn_cuda(
            conv, xs, xd, nbr, ln, m, proj, **kw),
        **{flag: (lambda fn=fn: edge_stage.launch_edge_attn(
            fn, stream(), *args)) for flag, fn in extra.items()},
    }
    ref = period_conv.edge_attn_plain(conv, xs, xd, nbr, ln, m, proj, **kw)
    return calls, ref


def attn_bound(inputs):
    """(bound ms, what bounds it) of chip_smoke.edge_attn_cost."""
    conv, xs, xd, _, _, m = inputs
    tc, fp32, bytes_ = cs.edge_attn_cost(xs, xd, m, conv.num_gates,
                                         conv.out_channels)
    return cs.bound(bytes_, (tc, cs.PEAK_TF32X3), (fp32, cs.PEAK_FP32))


def compare(name, inputs, others, extra, repeats):
    calls, ref = attn_calls(inputs, others, extra)
    err, branches = {}, None
    for who, fn in calls.items():
        if "PART" in who:                 # parts compute nothing of use
            continue
        edge_stage.reset_counts()
        out = fn()
        if who == "this":
            branches = dict(edge_stage.edge_attn_branches)
        try:
            err[who] = cs.close(f"edge_attn {name} {who}", out, ref)[0]
        except RuntimeError as e:         # this checkout's build must pass
            if who == "this":
                raise
            err[who] = str(e)
    ms = npc.timed(calls, repeats)
    _, xs, xd, nbr, _, m = inputs
    bound, by = attn_bound(inputs)
    best = {k: min(v) for k, v in ms.items()}
    print(json.dumps(dict(
        shape=name, Ns=xs.shape[0], Nd=xd.shape[0], K=nbr.shape[1],
        live=float(m.sum()), branch=branches, max_abs_err=err, ms=ms,
        ms_min=best, bound_ms=bound, bound_by=by,
        pct_of_bound={k: 100 * bound / v for k, v in best.items()})),
        flush=True)


def span_compare(cell, calls, others, repeats):
    """The span's 12 edge_attn launches together, each side."""
    per = [attn_calls(c, others, {})[0] for c in calls]
    fns = {who: (lambda who=who: [c[who]() for c in per]) for who in per[0]}
    edge_stage.reset_counts()
    fns["this"]()
    branches = dict(edge_stage.edge_attn_branches)
    ms = npc.timed(fns, repeats)
    bound = sum(attn_bound(c)[0] for c in calls)
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
    ap.add_argument("--single", default="",
                    help="only these of the other shapes, by name")
    args = ap.parse_args()
    cs.phase_device()
    dev = torch.device("cuda")
    specs = [(edge_stage.SOURCE, edge_stage.NVCC_FLAGS)] + [
        (edge_stage.SOURCE, edge_stage.NVCC_FLAGS + tuple(f.split()))
        for f in args.flags]
    log = _build.build(specs)
    others, ptxas = {}, {}
    for root in args.other:
        who = os.path.basename(os.path.normpath(root))
        launch, fn, ptxas[who] = build_other(root)
        others[who] = (launch, fn)
    print(json.dumps({"ptxas_this": {k: v["ptxas"] for k, v in log.items()},
                      "ptxas_other": ptxas}), flush=True)
    extra = {f: _build.function(edge_stage.SOURCE, "edge_attn_forward",
                                edge_stage._ATTN_ARGTYPES,
                                edge_stage.NVCC_FLAGS + tuple(f.split()))
             for f in args.flags}
    with torch.no_grad():
        reg, _, _ = checkpoint.load_model("artifacts/40um/regressor0", dev)
        cls, _, _ = checkpoint.load_model("artifacts/40um/classifier1", dev)
        for cell in filter(None, args.cells.split(",")):
            shapes, calls = cell_convs(cell, dev)
            for name, inputs in shapes.items():
                compare(f"{cell}_{name}", inputs, others, extra, args.repeats)
            span_compare(cell, calls, others, args.repeats)
            del shapes, calls
            torch.cuda.empty_cache()
        single = {} if args.no_single else single_lane_convs(reg, cls, dev)
        only = set(filter(None, args.single.split(",")))
        for name, inputs in single.items():
            if only and name not in only:
                continue
            compare(name, inputs, others, extra, args.repeats)


if __name__ == "__main__":
    main()
