"""The recorded stretch's reader (portbench/recorded.py) on a small synthetic
one: the program's spans put on the trace's clock by the recorder's anchor
and the trace's base, device operations tied to their launches, the idle
split by the innermost span (a partition of the idle time), and the three
readers on top of it; without a recorded stretch the readers read nothing."""

import pytest

from portbench import recorded, spec, tracing

P = 10 ** 9                     # the anchor's perf_counter_ns reading
T = 1_700_000_000_000_000_000   # its time_ns, and the trace's base


def span(name, t0_us, t1_us, parent, build=0, tid=1, **attrs):
    return {"name": name, "t0": P + t0_us * 1000, "t1": P + t1_us * 1000,
            "parent": parent, "build": build, "tid": tid, "attrs": attrs}


def synthetic():
    """A 10 ms stretch: one build (1-8 ms) of two spans and a capacity
    read, four kernels in it and one past it, on the trace's clock in
    us."""
    spans = [span("graingnn.build", 1000, 8000, -1, index=0, lanes=2),
             span("graingnn.span", 1000, 3000, 0, index=0),
             span("graingnn.sample", 1000, 1200, 1, index=0),
             span("graingnn.forward", 1200, 2500, 1, index=0),
             span("graingnn.conv", 1300, 1500, 3, index=0),
             span("graingnn.post", 2500, 3000, 1, index=0),
             span("graingnn.edit", 2600, 2800, 5, index=0),
             span("graingnn.span", 3000, 6000, 0, index=1),
             span("graingnn.post", 4000, 4500, 7, index=0),
             span("graingnn.edit", 4000, 4500, 8, index=0),
             span("graingnn.capacity_read", 6500, 7500, 0, index=0),
             span("graingnn.sample", 0, 9000, -1, build=-1, tid=2, index=0)]
    events = []
    for corr, name, launch, t0, dur in (
            (1, "node_proj_a", 1350, 1100, 900),
            (2, "editor_kernel", 4100, 3500, 700),
            (3, "edge_attn_b", 4900, 5000, 500),
            (4, "fill", 5400, 7000, 200),             # queued early
            (5, "late", 9900, 10000, 50)):            # past the window
        events.append({"cat": "cuda_runtime", "name": "cudaLaunchKernel",
                       "ts": launch, "dur": 5, "tid": 1,
                       "args": {"correlation": corr}})
        events.append({"cat": "kernel", "name": name, "ts": t0, "dur": dur,
                       "tid": 7, "args": {"correlation": corr}})
    doc = {"traceEvents": events, "baseTimeNanoseconds": T}
    rec = {"anchor": {"perf_counter_ns": P, "time_ns": T}, "spans": spans,
           "counters": {"0": {"switches": 3, "eliminations": 2,
                              "extra_events": 2}}}
    return recorded.read_recorded(doc, rec, (P, P + 10_000_000))


def test_spans_and_launches_on_the_trace_clock():
    rec = synthetic()
    assert rec.window == pytest.approx((0.0, 0.01))
    assert len(rec.spans) == 11                  # the other thread's left out
    assert (rec.spans[4].t0, rec.spans[4].t1) == pytest.approx((1.3e-3,
                                                                1.5e-3))
    assert [o.name for o in rec.ops] == ["node_proj_a", "editor_kernel",
                                         "edge_attn_b", "fill"]
    assert rec.ops[0].launch == pytest.approx(1.35e-3)
    assert recorded.launched_inside(rec, "graingnn.conv",
                                    ("node_proj", "edge_attn")) == (1, 2)
    assert recorded.launched_inside(rec, "graingnn.edit",
                                    ("editor_kernel",)) == (1, 1)


def test_the_idle_split_partitions_the_idle():
    split = recorded.idle_split(synthetic())
    assert split["window"] == pytest.approx(0.01)
    assert split["build_edge"] == pytest.approx(4.9e-3)
    assert split["host_issue"] == pytest.approx(1.8e-3)
    assert split["rest"] == pytest.approx(1.0e-3)
    assert split["idle"] == pytest.approx(7.7e-3)
    assert sum(split[k] for k in recorded.PARTS) == pytest.approx(
        split["idle"])


def test_the_late_part_is_idle_before_the_closing_launch():
    """The gap closed by "fill" (launched before it opened) is not late;
    the last gap has no closing operation."""
    late = recorded.late_split(synthetic())
    assert late["build_edge"] == pytest.approx(2.1e-3)
    assert late["host_issue"] == pytest.approx(1.2e-3)
    assert late["rest"] == pytest.approx(0.0)


@pytest.mark.parametrize("metric,want", [
    ("idle_build_edge_pct.sweep", 49.0),
    ("idle_host_issue_pct.sweep", 18.0),
    ("edit_us_per_event.sweep", 100.0)])
def test_readers(metric, want):
    tr = tracing.Trace((0, 1e-3), 1, [], 0, [], [], [], "fp32")
    assert spec.reader(metric)(tr) is None        # nothing recorded
    tr.recorded = synthetic()
    assert spec.reader(metric)(tr) == pytest.approx(want)
