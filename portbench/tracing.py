"""The traced window: torch.profiler over a few builds, its Chrome trace
read back into what the per-layer readers take. A traced run profiles two
stretches of builds: the first with the card's activity only (the device
timeline, whose busy and idle shares the host's profiling would
distort), the second with the host's operators too and the harness's
ranges installed (what each range launched, the host's calls).

Each device operation (kernel, copy, set) is tied to the host range it was
launched from through the profiler's correlation ids: the innermost of the
harness's record_function ranges (system.RANGES, the forward hooks)
around its launch. Device busy time is the union of the device
operations' intervals inside the window; an idle gap between two of them
is put down to the range that launched the operation ending it."""

from __future__ import annotations

import bisect
import dataclasses
import json
import os
import tempfile
from typing import Dict, List, Optional, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RANGE_NAMES = ("span", "sample", "forward", "conv", "post", "edit")
OUTSIDE = "outside_the_span_loop"
WINDOW = "portbench_window"   # the range around the traced builds


@dataclasses.dataclass
class DeviceOp:
    name: str
    t0: float          # seconds on the trace's clock
    t1: float
    path: str          # "span/forward/conv", or OUTSIDE


@dataclasses.dataclass
class Timeline:
    """The device's operations over a stretch of builds profiled with the
    card's activity only; window_s on the host clock, between two
    synchronisations."""
    window_s: float
    spans: int
    ops: List[Tuple[str, float, float]]     # (name, t0, t1), seconds

    def busy_s(self) -> float:
        """The union of the device operations' intervals."""
        total, end = 0.0, -float("inf")
        for _name, t0, t1 in sorted(self.ops, key=lambda o: o[1]):
            if t1 <= end:
                continue
            total += t1 - max(t0, end)
            end = t1
        return total


def read_timeline(events, spans: int, window_s: float) -> Timeline:
    return Timeline(window_s, spans, [
        (e["name"], e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6)
        for e in events if e.get("cat") in DEVICE_CATS])


@dataclasses.dataclass
class Trace:
    """What the per-layer readers take."""
    window: Tuple[float, float]      # the traced builds, host clock (s)
    spans: int                       # spans in the window
    span_host_s: List[float]         # host duration of each span range
    span_aten_calls: int             # top-level aten ops inside span ranges
    device_ops: List[DeviceOp]
    convs: List[Dict]                # each conv call's shapes, in order
    span_edges: List[float]          # live message edges of each span
    precision: str
    timeline: Optional[Timeline] = None   # the device-only stretch

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def device_s(self, *, inside: str, outside: Optional[str] = None):
        """Device seconds of the ops launched inside a range named `inside`
        (anywhere on their path) and not inside one named `outside`."""
        total = 0.0
        for o in self.device_ops:
            parts = o.path.split("/")
            if inside in parts and (outside is None or outside not in parts):
                total += o.t1 - o.t0
        return total


def _ranges_by_thread(events):
    """{tid: sorted [(t0, t1, name)]} of the harness's ranges."""
    out: Dict[int, List] = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("name") in RANGE_NAMES:
            t0 = e["ts"] * 1e-6
            out.setdefault(e["tid"], []).append(
                (t0, t0 + e.get("dur", 0) * 1e-6, e["name"]))
    for v in out.values():
        v.sort()
    return out


def _path(ranges, t: float) -> str:
    """The nested range names enclosing host time t, outermost first."""
    i = bisect.bisect_right(ranges, (t, float("inf"), ""))
    names = [name for t0, t1, name in ranges[max(0, i - 64):i]
             if t0 <= t <= t1]
    return "/".join(names) if names else OUTSIDE


def read_chrome_trace(events, convs, span_edges, precision) -> Trace:
    """The Trace of a profiler's Chrome trace events whose window is the
    range WINDOW."""
    ranges = _ranges_by_thread(events)
    marks = [e for e in events if e.get("cat") == "user_annotation"
             and e.get("name") == WINDOW]
    if len(marks) != 1:
        raise RuntimeError(f"the trace holds {len(marks)} {WINDOW} ranges")
    window = (marks[0]["ts"] * 1e-6,
              (marks[0]["ts"] + marks[0]["dur"]) * 1e-6)
    launch = {}                       # correlation id -> (tid, host time)
    for e in events:
        if e.get("cat") in ("cuda_runtime", "cuda_driver"):
            corr = e.get("args", {}).get("correlation")
            if corr is not None:
                launch[corr] = (e["tid"], e["ts"] * 1e-6)
    ops = []
    for e in events:
        if e.get("cat") not in DEVICE_CATS:
            continue
        t0 = e["ts"] * 1e-6
        if not window[0] <= t0 < window[1]:
            continue
        corr = e.get("args", {}).get("correlation")
        path = OUTSIDE
        if corr in launch:
            tid, t_launch = launch[corr]
            path = _path(ranges.get(tid, []), t_launch)
        ops.append(DeviceOp(e["name"], t0, t0 + e.get("dur", 0) * 1e-6,
                            path))
    spans = [r for v in ranges.values() for r in v if r[2] == "span"]
    span_host = [t1 - t0 for t0, t1, _ in spans]
    aten = [(e["ts"] * 1e-6, (e["ts"] + e.get("dur", 0)) * 1e-6, e["tid"])
            for e in events if e.get("cat") == "cpu_op"
            and e.get("name", "").startswith("aten::")]
    calls = 0
    for tid in {a[2] for a in aten}:
        mine = sorted(a[:2] for a in aten if a[2] == tid)
        span_iv = sorted(s[:2] for s in ranges.get(tid, []) if s[2] == "span")
        end = -1.0                       # end of the last top-level op
        for t0, t1 in mine:
            if t0 < end:
                continue                 # nested in an aten op
            end = t1
            j = bisect.bisect_right(span_iv, (t0, float("inf"))) - 1
            if j >= 0 and span_iv[j][0] <= t0 <= span_iv[j][1]:
                calls += 1
    return Trace(window=window, spans=len(spans), span_host_s=span_host,
                 span_aten_calls=calls, device_ops=ops, convs=convs,
                 span_edges=span_edges, precision=precision)


def profiled(cpu: bool):
    """A torch.profiler over the card, and with cpu=True over the host's
    operators too; no shapes, no stacks."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    return profile(activities=acts)


def trace_events(prof) -> List[Dict]:
    """The profiler's Chrome trace events, through a file under TMPDIR that
    is removed after reading."""
    fd, path = tempfile.mkstemp(prefix="portbench_trace_", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)
