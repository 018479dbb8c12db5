"""The recorded stretch: builds run with the card's activity profiled and the
port's own spans and counters recorded (graingraphnn_torch.utils.profiling:
recording()), with no host profiling and none of the harness's ranges.
What it reads, and the readers of metrics/idle_build_edge_pct.sweep,
metrics/idle_host_issue_pct.sweep and metrics/edit_us_per_event.sweep,
take it as a trace's `recorded` attribute (a Recorded; absent, they read
nothing).

The program's spans are stamped on time.perf_counter_ns; the recorder's
anchor (one perf_counter_ns reading beside time.time_ns) puts them in Unix
time, and the Chrome trace's baseTimeNanoseconds on the trace's clock
(ts + baseTimeNanoseconds / 1e3 is Unix microseconds). Each device
operation is tied to its launch (the host's cuda_runtime or cuda_driver
call) through the profiler's correlation ids.

Idle time, the instants of the stretch at which no device operation runs,
is put down to the innermost program span open at that instant on the
thread that runs the rollout (idle_split), and falls into three parts:
build_edge (in graingnn.capacity_read, outside every graingnn.build, or in
span 0 of a build: the drain at a build's end and the refill after it),
host_issue (in spans 1 and later of a build, while the host issues them;
late_split says how much of it waited for a launch call) and rest (in a
build, outside its spans and its capacity read). They add up to the
stretch's idle time.

    python3 -m portbench.recorded --workload <cell> --seed <n>

runs a cell's set-up as portbench.run does, then a device-only stretch and
a recorded stretch of the same builds, and prints one JSON line: the three
readers' values, the idle split and the part of it before each gap's
closing launch (late_split), the device-only stretch's idle, the shares of
the conv and editor kernels launched inside their spans, each build's
counters and the recorder's host cost a span. It exits non-zero, printing
no result, where the port has no recording() (then nothing of this can be
read) or without a card.
"""

from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

BUILD = "graingnn.build"
SPAN = "graingnn.span"
CAPACITY_READ = "graingnn.capacity_read"
PARTS = ("build_edge", "host_issue", "rest")


@dataclasses.dataclass
class LaunchedOp:
    name: str
    t0: float                 # seconds on the trace's clock
    t1: float
    launch: Optional[float]   # the host's launch call, None where unknown


@dataclasses.dataclass
class ProgramSpan:
    name: str
    t0: float                 # seconds on the trace's clock
    t1: float
    parent: int               # index into Recorded.spans, -1 for none
    build: int
    attrs: Dict


@dataclasses.dataclass
class Recorded:
    """A recorded stretch on the trace's clock: its window (host, between
    two synchronisations), the device operations starting inside it, the
    program's spans on the rollout's thread, and each build's counters."""
    window: Tuple[float, float]
    ops: List[LaunchedOp]
    spans: List[ProgramSpan]
    counters: Dict[int, Dict[str, int]]

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]


def read_recorded(doc: Dict, spans_json: Dict,
                  window_ns: Tuple[int, int]) -> Recorded:
    """The Recorded of a profiler's Chrome trace `doc` (the whole file,
    card activity), a Recorder's to_json() and the stretch's window as two
    perf_counter_ns readings."""
    from .tracing import DEVICE_CATS

    base = doc["baseTimeNanoseconds"]
    anchor = spans_json["anchor"]

    def clock(t_ns):
        return (anchor["time_ns"] + t_ns - anchor["perf_counter_ns"]
                - base) * 1e-9

    window = (clock(window_ns[0]), clock(window_ns[1]))
    raw = spans_json["spans"]
    tids = {s["tid"] for s in raw if s["name"] == BUILD}
    keep = [i for i, s in enumerate(raw) if s["tid"] in tids]
    new = {old: i for i, old in enumerate(keep)}
    spans = [ProgramSpan(
        s["name"], clock(s["t0"]),
        clock(s["t1"] if s["t1"] is not None else window_ns[1]),
        new.get(s["parent"], -1), s["build"], s["attrs"])
        for s in (raw[i] for i in keep)]
    events = doc["traceEvents"]
    launches: Dict = {}
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launches[corr] = (e.get("tid"), e["ts"] * 1e-6)
    mine = {tid for tid, _ in launches.values()} & tids
    ops = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        t0 = e["ts"] * 1e-6
        if not window[0] <= t0 < window[1]:
            continue
        tid, launch = launches.get(e.get("args", {}).get("correlation"),
                                   (None, None))
        if mine and tid not in mine:
            launch = None
        ops.append(LaunchedOp(e["name"], t0, t0 + e.get("dur", 0) * 1e-6,
                              launch))
    counters = {int(b): dict(c) for b, c in spans_json["counters"].items()}
    return Recorded(window, ops, spans, counters)


def gaps(rec: Recorded) -> List[Tuple[float, float, Optional[LaunchedOp]]]:
    """The stretch's instants on which no device operation runs, as
    (t0, t1, the operation that ends the gap, None at the window's end)."""
    out, end = [], rec.window[0]
    for op in sorted(rec.ops, key=lambda o: o.t0):
        if op.t0 > end:
            out.append((end, min(op.t0, rec.window[1]), op))
        end = max(end, op.t1)
    if rec.window[1] > end:
        out.append((end, rec.window[1], None))
    return [g for g in out if g[1] > g[0]]


def innermost(rec: Recorded) -> List[Tuple[float, float, int]]:
    """(t0, t1, span) covering the window in order: the innermost program
    span open over each piece (-1 for none). Spans nest on the rollout's
    thread."""
    children: Dict[int, List[int]] = {}
    for i, s in enumerate(rec.spans):
        children.setdefault(s.parent, []).append(i)
    out: List[Tuple[float, float, int]] = []

    def walk(i, t0, t1):
        t = t0
        for c in sorted(children.get(i, []), key=lambda c: rec.spans[c].t0):
            a = max(rec.spans[c].t0, t)
            b = min(rec.spans[c].t1, t1)
            if b <= a:
                continue
            out.append((t, a, i))
            walk(c, a, b)
            t = b
        out.append((t, t1, i))

    walk(-1, *rec.window)
    return [(a, b, i) for a, b, i in out if b > a]


def part_of(rec: Recorded, i: int) -> str:
    """The idle part that time in span i (innermost) belongs to."""
    while i >= 0:
        s = rec.spans[i]
        if s.name == CAPACITY_READ:
            return "build_edge"
        if s.name == SPAN:
            return "build_edge" if s.attrs.get("index") == 0 else "host_issue"
        if s.name == BUILD:
            return "rest"
        i = s.parent
    return "build_edge"            # outside every build


def idle_split(rec: Recorded) -> Dict[str, float]:
    """Idle seconds by part (PARTS), with their sum "idle" and the
    stretch's "window"."""
    idle = [(a, b) for a, b, _ in gaps(rec)]
    parts = by_part(rec, idle)
    parts["idle"] = sum(b - a for a, b in idle)
    parts["window"] = rec.window_s
    return parts


def late_split(rec: Recorded) -> Dict[str, float]:
    """Idle seconds by part before the host's launch of the operation that
    ends each gap: the card waiting for the launch call. The rest of a gap,
    after that launch, is the time a launched operation took to start."""
    late = [(a, min(op.launch, b)) for a, b, op in gaps(rec)
            if op is not None and op.launch is not None and op.launch > a]
    return by_part(rec, late)


def by_part(rec: Recorded, intervals) -> Dict[str, float]:
    """Seconds of sorted, disjoint intervals by the part (PARTS) of the
    innermost span open over each instant."""
    parts = dict.fromkeys(PARTS, 0.0)
    segs = innermost(rec)
    j = 0
    for a, b in intervals:
        while j < len(segs) and segs[j][1] <= a:
            j += 1
        k = j
        while k < len(segs) and segs[k][0] < b:
            lo, hi = max(a, segs[k][0]), min(b, segs[k][1])
            if hi > lo:
                parts[part_of(rec, segs[k][2])] += hi - lo
            k += 1
    return parts


def _inside(rec: Recorded, name: str):
    """Sorted (t0, t1) of the program spans named `name`."""
    return sorted((s.t0, s.t1) for s in rec.spans if s.name == name)


def _launched_in(ivs, t: Optional[float]) -> bool:
    if t is None:
        return False
    i = bisect.bisect_right(ivs, (t, float("inf"))) - 1
    return i >= 0 and ivs[i][0] <= t <= ivs[i][1]


def launched_inside(rec: Recorded, span_name: str, op_names) -> Tuple:
    """(inside, of): the device operations whose name holds one of
    op_names, and of those the ones launched inside a `span_name` span."""
    ivs = _inside(rec, span_name)
    ops = [o for o in rec.ops if any(n in o.name for n in op_names)]
    return sum(_launched_in(ivs, o.launch) for o in ops), len(ops)


def device_s_inside(rec: Recorded, span_name: str) -> float:
    """Device seconds of the operations launched inside `span_name` spans."""
    ivs = _inside(rec, span_name)
    return sum(o.t1 - o.t0 for o in rec.ops if _launched_in(ivs, o.launch))


def events(rec: Recorded) -> int:
    """The editor's switches, eliminations and extra events over the
    stretch's builds."""
    return sum(c.get("switches", 0) + c.get("eliminations", 0)
               + c.get("extra_events", 0) for c in rec.counters.values())


def chrome_trace(prof) -> Dict:
    """The profiler's whole Chrome trace, through a file under TMPDIR that
    is removed after reading."""
    fd, path = tempfile.mkstemp(prefix="portbench_recorded_",
                                suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)
    finally:
        os.remove(path)


def span_cost_us(profiling, n: int = 20000) -> Dict[str, float]:
    """The host's microseconds a span (enter and exit of a reused span
    object around nothing), with nothing recording and while recording."""
    sp = profiling.span("portbench.cost")

    def loop():
        t = time.perf_counter_ns()
        for _ in range(n):
            with sp:
                pass
        return (time.perf_counter_ns() - t) / n / 1e3

    off = loop()
    with profiling.recording():
        return {"off": off, "on": loop()}


def measure(cell, seed: int, device, builds: int = 2) -> Dict:
    """The cell's set-up, then `builds` builds (a traced run's stretch)
    profiled with the card's activity only and `builds` more recorded; the
    readers' values and what they rest on."""
    import torch

    from graingraphnn_torch.utils import profiling

    from . import system, tracing
    from . import traffic as traffic_mod
    from .run import card_line, sync
    from .spec import reader

    on_card = torch.device(device).type == "cuda"
    with torch.no_grad():
        program = system.Program(cell.config, cell.traffic, device)
        graphs = traffic_mod.lane_graphs(cell.traffic, seed)
        start, _ = traffic_mod.starting_state(graphs, device)
        program.run(start)                                  # warm-up
        sync(device)
        with tracing.profiled(cpu=not on_card) as prof_device:
            sync(device)
            t = time.perf_counter()
            for _ in range(builds):
                program.run(start)
            sync(device)
            device_window_s = time.perf_counter() - t
        timeline = tracing.read_timeline(
            tracing.trace_events(prof_device),
            cell.traffic["spans"] * builds, device_window_s)
        with tracing.profiled(cpu=not on_card) as prof, \
                profiling.recording() as rec:
            sync(device)
            ta = time.perf_counter_ns()
            for _ in range(builds):
                program.run(start)
            sync(device)
            tb = time.perf_counter_ns()
        recorded = read_recorded(chrome_trace(prof), rec.to_json(),
                                 (ta, tb))
    tr = tracing.Trace((0.0, 0.0), 0, [], 0, [], [], [],
                       cell.config["precision"], timeline)
    tr.recorded = recorded
    split = idle_split(recorded)
    pct = {k: 100.0 * v / split["window"] for k, v in split.items()
           if k != "window"}
    late_pct = {k: 100.0 * v / split["window"]
                for k, v in late_split(recorded).items()}
    device_idle = reader("device_idle_pct.sweep")(tr)
    conv_in, conv_of = launched_inside(recorded, "graingnn.conv",
                                       ("node_proj", "edge_attn"))
    edit_in, edit_of = launched_inside(recorded, "graingnn.edit",
                                       ("editor_kernel",))
    n_spans = len(rec.spans)
    rollout_spans = sum(1 for s in rec.spans if s["name"] == SPAN)
    cost = span_cost_us(profiling)
    return {
        "workload": cell.name, "seed": seed,
        "metrics": {m: reader(m)(tr) for m in (
            "idle_build_edge_pct.sweep", "idle_host_issue_pct.sweep",
            "edit_us_per_event.sweep")},
        "idle_pct": pct,
        "late_pct": late_pct,
        "device_only_idle_pct": device_idle,
        "tracing_cost_idle_pct": (None if device_idle is None
                                  else pct["idle"] - device_idle),
        "window_s": {"device_only": timeline.window_s,
                     "recorded": recorded.window_s},
        "conv_launches_inside": [conv_in, conv_of],
        "editor_launches_inside": [edit_in, edit_of],
        "counters": recorded.counters,
        "program_spans": n_spans,
        "program_spans_a_rollout_span": n_spans / max(rollout_spans, 1),
        "recorder_us_a_span": cost,
        "card": card_line() if on_card else "cpu",
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    args = ap.parse_args(argv)

    from graingraphnn_torch.utils import profiling

    from . import spec
    from .run import cache_dirs

    if not hasattr(profiling, "recording"):
        print("portbench.recorded: the port records no spans. No result.",
              file=sys.stderr)
        return 2
    import torch

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available():
        print("portbench.recorded: no CUDA device. No result.",
              file=sys.stderr)
        return 2
    cache_dirs(spec.ROOT)
    print(json.dumps(measure(cell, args.seed, "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
