"""One run of one cell of the port's benchmark.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

Set-up (timed as setup_s, from this module's first line to the first timed
build): the port's imports and kernels, the cell's two checkpoints, the
lanes' starting graphs from the seed (traffic.py), one warm-up build. Then builds run
back to back for --seconds (a closed loop); the window closes at the end
of the first build past that time (and not before the checked build).
--trace 0 reports the cell's end-to-end metrics, --trace 1 its per-layer
ones from torch.profiler over the window's first builds: two builds with
the card's activity only, then two with the host's operators and the
harness's ranges around the port's entry points (installed there only).
Then one build of the window is held
against the plain reference (check.py); each number compared goes to
standard error beside its limit, and the result is the last line of
standard output, one JSON object.

It exits non-zero, printing no result, without a card (or with fewer than
the cell asks for), and if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse   # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "graingraphnn_tpu")
TRACED_BUILDS = 2        # builds in each traced stretch
CACHE = ".portbench_cache"   # build and kernel caches, inside the checkout


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the port must not load."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def cache_dirs(root: str):
    """Every build and kernel cache under the checkout, at fixed paths."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        path = os.path.join(root, CACHE, sub)
        os.makedirs(path, exist_ok=True)
        os.environ[var] = path


def card_line() -> str:
    """nvidia-smi's name and power limit of the card, or why not."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi: not read"


def _name(s: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", s)[:64]


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def breakdown(trace, top: int = 10) -> Dict:
    """The device ops that took most time (the device-only stretch), and
    the longest idle gaps by the range that launched the op ending each
    (the stretch with the ranges)."""
    by_op: Dict[str, float] = {}
    for name, t0, t1 in trace.timeline.ops:
        by_op[_name(name)] = by_op.get(_name(name), 0.0) + (t1 - t0)
    gaps: Dict[str, float] = {}
    w0, w1 = trace.window
    end = w0
    for o in sorted(trace.device_ops, key=lambda o: o.t0):
        if o.t0 > end:
            gaps[o.path] = gaps.get(o.path, 0.0) + (o.t0 - end)
        end = max(end, o.t1)
    if w1 > end:
        gaps["after_the_last_device_operation"] = w1 - end
    return {"device_ops": sorted(([k, v] for k, v in by_op.items()),
                                 key=lambda kv: -kv[1])[:top],
            "idle_gaps": sorted(([k, v] for k, v in gaps.items()),
                                key=lambda kv: -kv[1])[:top]}


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, fault=None):
    """One run of `cell` on `device` ("cuda", or "cpu" for the tests, where
    the port takes its plain versions). fault(program), where given, is a
    context manager that breaks the timed path for the whole window.
    Returns (result, lines): the result's fields, and the lines that state
    each number compared beside its limit."""
    import torch

    from . import check, system, tracing
    from . import traffic as traffic_mod
    from .spec import reader

    cfg, traffic = cell.config, cell.traffic
    on_card = torch.device(device).type == "cuda"
    lines: List[str] = []
    marks = {"imports": time.perf_counter() - t_start}
    with torch.no_grad():
        program = system.Program(cfg, traffic, device)
        marks["program"] = time.perf_counter() - t_start
        graphs = traffic_mod.lane_graphs(traffic, seed)
        start, singles = traffic_mod.starting_state(graphs, device)
        marks["lanes"] = time.perf_counter() - t_start
        program.run(start)                              # warm-up
        sync(device)
    setup_s = time.perf_counter() - t_start
    marks["warmup"] = setup_s

    recorder = system.Recorder()
    check_build = seed % 2
    ranges = system.Ranges(program)
    edges: List = []
    traced_edges: List = []
    builds = failed = 0
    system.reset_launches()
    if on_card:
        torch.cuda.reset_peak_memory_stats()

    def build():
        nonlocal builds, failed
        rec = (recorder.recording() if builds == check_build
               else contextlib.nullcontext())
        try:
            with rec:
                _, aux = program.run(start)
            edges.append(aux["message_edges"])
        except RuntimeError as err:
            if "capacity bust" not in str(err):
                raise
            lines.append(f"build {builds}: {err}")
            failed += 1
        builds += 1

    broken = fault(program) if fault else contextlib.nullcontext()
    with torch.no_grad(), broken:
        sync(device)
        t0 = time.perf_counter()
        if trace:
            with tracing.profiled(cpu=False) as prof_device:
                sync(device)
                ta = time.perf_counter()
                for _ in range(TRACED_BUILDS):
                    build()
                sync(device)
                device_window_s = time.perf_counter() - ta
            # each profiler's trace is read before the next one starts
            device_events = tracing.trace_events(prof_device)
            n_device = len(edges)
            with tracing.profiled(cpu=True) as prof, ranges.installed():
                with torch.profiler.record_function(tracing.WINDOW):
                    for _ in range(TRACED_BUILDS):
                        build()
                    sync(device)
            range_events = tracing.trace_events(prof)
            traced_edges = edges[n_device:]
        while not failed and (builds <= check_build
                              or time.perf_counter() - t0 < seconds):
            build()
        sync(device)
        t1 = time.perf_counter()
    window_s = t1 - t0
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    got = system.launches()
    want = system.expected_launches(cfg["precision"],
                                    traffic["spans"] * builds, on_card)
    launch_mismatch = sum(abs(got[k] - want[k]) for k in want)
    if launch_mismatch:
        lines.append(f"launches {got}, want {want} "
                     f"({builds} builds of {traffic['spans']} spans)")
    found = forbidden_modules()
    if found:
        return None, lines + [f"loaded after the window: {found}"]
    total_edges = float(sum(float(e.sum()) for e in edges))
    conv_calls = ranges.convs
    del program, ranges, edges          # the reference runs after them
    if on_card:
        torch.cuda.empty_cache()

    ref = check.Reference(cfg, device)
    pairs = check.sampled_pairs(traffic["spans"], traffic["lanes"],
                                traffic["check_lane_spans"], seed)
    numbers = check.check_spans(recorder.spans, ref, cfg, traffic, pairs,
                                cfg["precision"], check.sampled_spans(
                                    traffic["spans"], traffic["check_spans"],
                                    seed))
    if len(recorder.spans) != traffic["spans"]:
        lines.append(f"recorded {len(recorder.spans)} spans of build "
                     f"{check_build}, want {traffic['spans']}")
        numbers["topology_mismatch"] += 1
    numbers["start_invalid"] = check.start_invalid(
        system.state_dict(start), [system.state_dict(s) for s in singles],
        graphs)
    numbers["launch_mismatch"] = launch_mismatch
    limits = cfg["limits"]
    correct = check.judge(numbers, limits) and failed == 0

    card = card_line() if on_card else "cpu"
    result = {"correct": bool(correct), "attempted": builds,
              "failed": failed}
    metrics = {}
    if trace:
        spans_edges = [float(s) for e in traced_edges for s in e.sum(-1)]
        tr = tracing.read_chrome_trace(range_events, conv_calls,
                                       spans_edges, cfg["precision"])
        tr.timeline = tracing.read_timeline(
            device_events, traffic["spans"] * TRACED_BUILDS, device_window_s)
        for m in cell.per_layer:
            value = reader(m["name"])(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
                if m["unit"] == "%":
                    lines.append(f"{m['name']} {value} % ({card})")
        device_info = {"busy_s": tr.timeline.busy_s(),
                       "window_s": tr.timeline.window_s}
        result_breakdown = breakdown(tr)
    else:
        values = {"edges_per_s": total_edges / window_s, "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
        device_info = {}
        result_breakdown = None
    result["metrics"] = metrics
    result["device"] = dict(
        platform="gpu" if on_card else "cpu",
        kind=torch.cuda.get_device_name(0) if on_card else "cpu",
        count=cell.chips if on_card else 0, memory_peak_bytes=int(peak),
        **device_info)
    if result_breakdown is not None:
        result["breakdown"] = result_breakdown
    result["card"] = card
    result["setup"] = marks
    result["window"] = {"seconds": window_s, "builds": builds,
                        "edges": total_edges, "checked_build": check_build,
                        "check_seconds": numbers["seconds"]}
    result["check"] = {k: {"value": numbers[k], "limit": limits[k]}
                       for k in limits}
    lines.append("gap by head " + json.dumps(numbers["heads"])
                 + f" (the check took {numbers['seconds']})")
    lines += [f"{k} {numbers[k]} limit {limits[k]}" for k in limits]
    if not all(math.isfinite(float(v["value"])) for v in metrics.values()):
        raise RuntimeError(f"a metric is not finite: {metrics}")
    return result, lines


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from . import spec

    cell = spec.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or (torch.cuda.device_count()
                                         < cell.chips):
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {cell.chips} CUDA device(s); "
              f"{n} found. No result.", file=sys.stderr)
        return 2
    cache_dirs(spec.ROOT)
    result, lines = run_cell(cell, args.seed, args.seconds,
                             bool(args.trace), "cuda", T_START)
    for line in lines:
        print(line, file=sys.stderr)
    if result is None:
        print("portbench: no result", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
