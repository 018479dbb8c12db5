"""Tracing and cost accounting.

  * `span(name, **attrs)`: a named span at a layer boundary, as a decorator
    or a context manager. Outside `recording()` a span checks one
    module-level flag and does nothing else: no record_function, no
    allocation, no device operation.
  * `recording(ranges=False)`: keeps every span of the block in memory (a
    `Recorder`: name, start and end on time.perf_counter_ns, parent,
    build, attributes) and the counters each build files; with ranges=True
    each span also opens a torch.profiler.record_function of its name.
  * `trace(logdir)`: torch.profiler (CPU, and the card's activity where
    there is one) with recording and ranges on; writes logdir/trace.json
    (chrome://tracing, Perfetto) and logdir/spans.json (Recorder.to_json).
  * analytic operation and byte counts of the fused periodic conv and of
    the whole GrainNN forward, the JAX package's arithmetic.

H100_PEAK_* are the NVIDIA H100 SXM datasheet peaks that chip_smoke.py's
bounds use; they are datasheet figures, not measurements, and a card run
below its 700 W limit reaches less.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
import time
from typing import Dict, List, Optional

import torch

# NVIDIA H100 SXM datasheet peaks (chip_smoke.py's bounds use these)
H100_PEAK_FP32 = 67e12          # fp32 outside the tensor cores, FLOP/s
H100_PEAK_TF32X3 = 495e12 / 3   # TF32 tensor cores, 3 products per fp32 one
H100_PEAK_BF16 = 989e12         # bf16 tensor cores, dense, FLOP/s
H100_PEAK_BYTES = 3.35e12       # HBM3, bytes/s

BUILD = "graingnn.build"   # a build is the request: its spans share its id

_recorder: Optional["Recorder"] = None    # the flag every span checks


class _Thread:
    """One thread's native id (read once: a system call), its open spans
    (indices into Recorder.spans) and their record_function ranges."""

    def __init__(self):
        self.tid = threading.get_native_id()
        self.open: List[int] = []
        self.ranges: List = []


class Recorder:
    """The spans and counters of what runs inside `recording()`.

    spans: one dict a span, in the order they opened: name, t0 and t1
    (time.perf_counter_ns; t1 None if the span was still open when
    recording ended), parent (an index into spans, -1 for none), build (the
    id of the enclosing BUILD span, -1 outside every build), tid (the
    thread's native id, as a profiler's trace gives it) and attrs (the
    span's own, plus "index": its rank among its parent's children of the
    same name). counters: {build id: {name: value}}, filed by count() from
    inside the build.

    anchor pairs one time.perf_counter_ns() reading with time.time_ns(), so
    a span's times convert to Unix time (unix_ns) and from there to a
    Chrome trace's clock, on which ts + baseTimeNanoseconds / 1e3 is Unix
    microseconds."""

    def __init__(self, ranges: bool = False):
        self.ranges = ranges
        self.anchor = (time.perf_counter_ns(), time.time_ns())
        self.spans: List[Dict] = []
        self.counters: Dict[int, Dict[str, int]] = {}
        self._threads: Dict[int, _Thread] = {}
        self._siblings: Dict = {}
        self._builds = 0
        self._lock = threading.Lock()

    def _thread(self) -> _Thread:
        key = threading.get_ident()
        th = self._threads.get(key)
        if th is None:
            th = self._threads[key] = _Thread()
        return th

    def open(self, name: str, attrs: Dict):
        th = self._thread()
        parent = th.open[-1] if th.open else -1
        with self._lock:
            index = self._siblings.get((parent, name), 0)
            self._siblings[(parent, name)] = index + 1
            if name == BUILD:
                build = self._builds
                self._builds += 1
            else:
                build = self.spans[parent]["build"] if parent >= 0 else -1
            th.open.append(len(self.spans))
            self.spans.append({"name": name, "t0": time.perf_counter_ns(),
                               "t1": None, "parent": parent, "build": build,
                               "tid": th.tid,
                               "attrs": {**attrs, "index": index}})
        if self.ranges:
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            th.ranges.append(rf)

    def close(self):
        th = self._thread()
        if not th.open:
            return
        if self.ranges:
            th.ranges.pop().__exit__(None, None, None)
        self.spans[th.open.pop()]["t1"] = time.perf_counter_ns()

    def annotate(self, **attrs):
        """Adds attrs to the innermost span open on this thread."""
        th = self._thread()
        if th.open:
            self.spans[th.open[-1]]["attrs"].update(attrs)

    def count(self, values: Dict[str, int]):
        """Files values under the build of the innermost span open on this
        thread (-1 outside every build)."""
        th = self._thread()
        build = self.spans[th.open[-1]]["build"] if th.open else -1
        self.counters.setdefault(build, {}).update(values)

    def unix_ns(self, t: int) -> int:
        """A perf_counter_ns reading as Unix nanoseconds."""
        return self.anchor[1] + (t - self.anchor[0])

    def to_json(self) -> Dict:
        return {"anchor": {"perf_counter_ns": self.anchor[0],
                           "time_ns": self.anchor[1]},
                "spans": self.spans,
                "counters": {str(b): c for b, c in self.counters.items()}}


class span:
    """A span named `name` with attrs, around a block (`with span(...):`) or
    around every call of a function (`@span(...)`). Make the object once
    (at import, for a decorator) and reuse it: while nothing records,
    entering it checks the module's flag and does nothing else."""

    __slots__ = ("name", "attrs")

    def __init__(self, name: str, **attrs):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        if _recorder is not None:
            _recorder.open(self.name, self.attrs)

    def __exit__(self, *exc):
        if _recorder is not None:
            _recorder.close()
        return False

    def __call__(self, fn):
        name, attrs = self.name, self.attrs

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            rec = _recorder
            if rec is None:
                return fn(*args, **kwargs)
            rec.open(name, attrs)
            try:
                return fn(*args, **kwargs)
            finally:
                rec.close()
        return spanned


def recorder() -> Optional[Recorder]:
    """The Recorder of the recording() in progress, or None."""
    return _recorder


@contextlib.contextmanager
def recording(ranges: bool = False):
    """Record every span of the block; yields the Recorder. One recording
    at a time in a process."""
    global _recorder
    if _recorder is not None:
        raise RuntimeError("a recording is already in progress")
    rec = Recorder(ranges)
    _recorder = rec
    try:
        yield rec
    finally:
        _recorder = None


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with torch.profiler (the card's activity too when
    CUDA is available) and record its spans with ranges; on exit write
    logdir/trace.json and logdir/spans.json. Yields the profiler
    (key_averages() for a table)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with recording(ranges=True) as rec, profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
    with open(os.path.join(logdir, "spans.json"), "w") as f:
        json.dump(rec.to_json(), f)


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
