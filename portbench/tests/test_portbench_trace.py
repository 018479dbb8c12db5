"""The trace reader on a small synthetic Chrome trace: device time by the
range that launched each operation, top-level aten calls inside spans,
busy time as the union of intervals, and the readers on top of it."""

import pytest

from portbench import spec, tracing


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid,
         "ph": "X"}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def synthetic():
    """One span of 1000 us on the host: a sample range launching one
    kernel, a forward with a conv launching two, a post with an edit
    launching one, and one kernel launched outside any range."""
    e = [ev("user_annotation", tracing.WINDOW, 0, 2000),
         ev("user_annotation", "span", 100, 1000),
         ev("user_annotation", "sample", 110, 100),
         ev("user_annotation", "forward", 300, 400),
         ev("user_annotation", "conv", 310, 200),
         ev("user_annotation", "post", 800, 250),
         ev("user_annotation", "edit", 900, 100),
         ev("cpu_op", "aten::sort", 120, 50),
         ev("cpu_op", "aten::empty", 130, 5),        # nested: not counted
         ev("cpu_op", "aten::mm", 320, 20),
         ev("cpu_op", "aten::add", 1500, 10)]        # outside the span
    launches = [(1, 150, 300, 50), (2, 350, 500, 100), (3, 400, 600, 100),
                (4, 950, 1200, 200), (5, 1600, 1700, 10)]
    for corr, t_launch, t_dev, dur in launches:
        e.append(ev("cuda_runtime", "cudaLaunchKernel", t_launch, 5,
                    corr=corr))
        e.append(ev("kernel", f"k{corr}", t_dev, dur, tid=7, corr=corr))
    return e


def test_device_time_by_range():
    tr = tracing.read_chrome_trace(synthetic(), [], [], "fp32")
    assert tr.spans == 1
    assert tr.window_s == pytest.approx(2000e-6)
    assert tr.device_s(inside="sample") == pytest.approx(50e-6)
    assert tr.device_s(inside="conv") == pytest.approx(200e-6)
    assert tr.device_s(inside="forward") == pytest.approx(200e-6)
    assert tr.device_s(inside="edit") == pytest.approx(200e-6)
    assert tr.device_s(inside="post", outside="edit") == pytest.approx(0.0)
    assert tr.span_aten_calls == 2
    paths = {o.name: o.path for o in tr.device_ops}
    assert paths["k2"] == "span/forward/conv"
    assert paths["k5"] == tracing.OUTSIDE


def test_busy_is_a_union():
    t = tracing.Timeline(1e-3, 1, [("a", 0.0, 2e-4), ("b", 1e-4, 3e-4),
                                   ("c", 5e-4, 6e-4)])
    assert t.busy_s() == pytest.approx(4e-4)
    assert spec.reader("device_idle_pct.sweep")(
        tracing.Trace((0, 1e-3), 1, [], 0, [], [], [], "fp32", t)) == \
        pytest.approx(60.0)


def test_readers_per_span():
    tr = tracing.read_chrome_trace(synthetic(), [], [], "fp32")
    assert spec.reader("sample_device_ms.sweep")(tr) == pytest.approx(0.05)
    assert spec.reader("aten_calls.sweep")(tr) == 2
    assert spec.reader("span_host_ms.sweep")(tr) == pytest.approx(1.0)
    assert spec.reader("conv_roofline_pct.sweep")(tr) is None  # no convs
