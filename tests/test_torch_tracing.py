"""The port's spans and counters on the CPU (utils/profiling, the spans of
rollout/device_rollout and ops/period_conv): with nothing recording a
span adds no operator and no annotation; a recorded build of two small
lanes (or of one lane, through make_rollout) has the layers' hierarchy,
the next state of an unrecorded one, spans on the profiler's clock, and
counters equal to a host recount; a dropped jj edge is flagged and counted
and does not stop the build. Two 40 um lanes from the port's generator
(seeds 5 and 7), narrow random models that switch and eliminate."""

import contextlib
import json
from collections import Counter

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from graingraphnn_torch.models import cells, grain_nn, hyper
from graingraphnn_torch.rollout import device_driver as dd
from graingraphnn_torch.rollout import device_rollout as dr
from graingraphnn_torch.utils import profiling

FIELDS = ("xg", "xj", "E_pp", "E_pq", "mask_g", "mask_j", "n_pp")
KW = dict(c_threshold=0.5, r_threshold=0.05)
MODES = ("batched", "single")
SPANNED = ("make_sample", "_pack_build_sample", "post_forward_step",
           "integrate_stage", "elim_candidates", "edit_stage",
           "finalize_stage", "batched_step", "device_step", "check_capacity")
SORT_SLACK_US = 50.0


@pytest.fixture(scope="module")
def lanes():
    states = []
    for seed in (5, 7):
        tr = dd.generate_trajectory(40, seed, 4.0, 1.0)
        states.append(dd.init_scaled_state(tr.x, tr.edges, tr.mask, tr.lxd,
                                           tr.patch_size, device="cpu")[0])
    gen = torch.Generator().manual_seed(0)
    reg = grain_nn.init_regressor(hyper.regressor(0, layer_size=16), gen)
    cls = grain_nn.init_classifier(
        hyper.classifier_transfered(1, layer_size=16), gen, regressor=reg)
    return states, (reg.eval(), cls.eval())


def start(lanes, mode):
    states = lanes[0]
    return dr.stack_states(states) if mode == "batched" else states[0]


def rollout(lanes, mode, n_steps=2):
    reg, cls = lanes[1]
    make = dr.make_rollout_batched if mode == "batched" else dr.make_rollout
    return make(reg, cls, n_steps=n_steps, **KW)


def step(lanes, mode, state):
    reg, cls = lanes[1]
    fn = dr.batched_step if mode == "batched" else dr.device_step
    return fn(reg, cls, state, **KW)


def assert_states_equal(a, b):
    for f in FIELDS:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def trace_events(prof, path):
    """The profiler's Chrome trace: (events, baseTimeNanoseconds)."""
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        doc = json.load(f)
    return doc["traceEvents"], doc["baseTimeNanoseconds"]


def names(events, prefix):
    return Counter(e["name"] for e in events
                   if e.get("name", "").startswith(prefix))


@pytest.mark.parametrize("mode", MODES)
def test_off_a_span_adds_nothing(lanes, mode, monkeypatch, tmp_path):
    """Nothing recording: a span of the rollout (every stage spanned) issues
    the aten operators of the same span with every span taken out, returns
    bit-equal results, opens no span and no profiler annotation."""
    st = start(lanes, mode)
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]) as p1:
        got, got_aux = step(lanes, mode, st)
    with monkeypatch.context() as m:
        for name in SPANNED:
            m.setattr(dr, name, getattr(dr, name).__wrapped__)
        m.setattr(cells, "apply_period_conv",
                  cells.apply_period_conv.__wrapped__)
        m.setattr(dr, "_FORWARD", dict.fromkeys(dr._FORWARD,
                                                contextlib.nullcontext()))
        with torch.no_grad(), profile(
                activities=[ProfilerActivity.CPU]) as p0:
            want, want_aux = step(lanes, mode, st)
    on, _ = trace_events(p1, tmp_path / "spanned.json")
    off, _ = trace_events(p0, tmp_path / "unspanned.json")
    assert names(on, "aten::") == names(off, "aten::")
    assert not names(on, "graingnn.")
    assert_states_equal(got, want)
    assert got_aux.keys() == want_aux.keys() | {"jg_overflow", "jj_overflow"}
    for k in want_aux:
        assert torch.equal(got_aux[k], want_aux[k]), k

    def refuse(*_a, **_k):
        raise AssertionError("a span opened with nothing recording")

    monkeypatch.setattr(profiling.Recorder, "open", refuse)
    with torch.no_grad():
        rollout(lanes, mode)(st)


def tree(rec, parent=-1):
    """The recorded spans under `parent` as (name, [children]) in order."""
    return [(s["name"], tree(rec, i)) for i, s in enumerate(rec.spans)
            if s["parent"] == parent]


def expected_tree(n_steps):
    forward = [("graingnn.conv", [])] * 6
    post = [("graingnn." + n, []) for n in ("integrate", "elim", "edit",
                                           "finalize")]
    span = [("graingnn.sample", []), ("graingnn.forward", forward),
            ("graingnn.forward", forward), ("graingnn.post", post)]
    return [(profiling.BUILD, [("graingnn.span", span)] * n_steps
             + [("graingnn.capacity_read", [])])]


@pytest.mark.parametrize("ranges", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_a_recorded_build_has_the_layers(lanes, mode, ranges, tmp_path):
    """build > {span x2 > {sample, forward x2 > conv x6, post > {integrate,
    elim, edit, finalize}}, capacity_read}, every span of build 0, inside
    its parent, with its index among its like siblings; with ranges, one
    profiler annotation a span."""
    prof = (profile(activities=[ProfilerActivity.CPU]) if ranges
            else contextlib.nullcontext())
    with torch.no_grad(), prof, profiling.recording(ranges=ranges) as rec:
        rollout(lanes, mode)(start(lanes, mode))
    assert profiling.recorder() is None
    assert tree(rec) == expected_tree(2)
    spans = rec.spans
    assert spans[0]["attrs"] == {"index": 0,
                                 "lanes": 2 if mode == "batched" else 1}
    for s in spans:
        assert s["build"] == 0 and s["t0"] <= s["t1"]
        if s["parent"] >= 0:
            p = spans[s["parent"]]
            assert p["t0"] <= s["t0"] and s["t1"] <= p["t1"]
    top = [s for s in spans if s["name"] == "graingnn.span"]
    assert [s["attrs"]["index"] for s in top] == [0, 1]
    models = [s["attrs"]["model"] for s in spans
              if s["name"] == "graingnn.forward"]
    assert models == ["regressor", "classifier"] * 2
    if ranges:
        annotated = names(trace_events(prof, tmp_path / "t.json")[0],
                          "graingnn.")
        assert annotated == Counter(s["name"] for s in spans)


@pytest.mark.parametrize("mode", MODES)
def test_recording_leaves_the_next_state_bit_equal(lanes, mode):
    st = start(lanes, mode)
    run = rollout(lanes, mode)
    with torch.no_grad():
        off, aux_off = run(st)
        with profiling.recording():
            on, aux_on = run(st)
    assert_states_equal(on, off)
    assert aux_on.keys() == aux_off.keys() | {"ring_high"}
    for k in aux_off:
        assert torch.equal(aux_on[k], aux_off[k]), k


def top_level(events, name, outer):
    """(t0, t1) in trace us of the `name` ops not nested in an `outer` op
    of the same thread."""
    outs = [(e["tid"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("name") == outer]
    return [(e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("name") == name and not any(
                tid == e["tid"] and a <= e["ts"] <= b for tid, a, b in outs)]


@pytest.mark.parametrize("mode", MODES)
def test_sample_spans_hold_their_sorts_on_the_trace_clock(lanes, mode,
                                                           tmp_path):
    """Converted by the recorder's anchor and the trace's
    baseTimeNanoseconds, each graingnn.sample span holds the three stable
    sorts of its ELL builds, to within SORT_SLACK_US."""
    with torch.no_grad(), profile(
            activities=[ProfilerActivity.CPU]) as prof, \
            profiling.recording() as rec:
        rollout(lanes, mode)(start(lanes, mode))
    events, base_ns = trace_events(prof, tmp_path / "trace.json")
    base_us = base_ns / 1e3
    sorts = top_level(events, "aten::sort", "aten::argsort")
    samples = [s for s in rec.spans if s["name"] == "graingnn.sample"]
    assert len(samples) == 2
    for s in samples:
        t0, t1 = (rec.unix_ns(s[k]) / 1e3 - base_us for k in ("t0", "t1"))
        inside = [(a, b) for a, b in sorts if t0 <= b and a <= t1]
        assert len(inside) == 3, (t0, t1, inside)
        for a, b in inside:
            assert t0 - SORT_SLACK_US <= a and b <= t1 + SORT_SLACK_US


def pull_degree_max(state):
    """The largest live pull degree of any grain, on the host."""
    e = state.E_pq.reshape(-1, *state.E_pq.shape[-2:]).numpy()
    return max(int(np.bincount(lane[1][(lane[0] >= 0) & (lane[1] >= 0)])
                   .max()) for lane in e)


@pytest.mark.parametrize("mode", MODES)
def test_counters_equal_a_host_recount(lanes, mode):
    st = start(lanes, mode)
    with torch.no_grad():
        with profiling.recording() as rec:
            _, aux = rollout(lanes, mode)(st)
        states = [st, step(lanes, mode, st)[0]]     # each span's start
    a = {k: v.numpy() for k, v in aux.items()}

    def spans_with(flag):
        return int(flag.reshape(2, -1).any(-1).sum())

    cap = st.E_pp.shape[-1]
    want = {"ring": 16, "pp_cap": cap,
            "switches": int((a["switching"][..., 0] >= 0).sum()),
            "eliminations": int((a["grain_events"] >= 0).sum()),
            "extra_events": int((a["extra_events"] >= 0).sum()),
            "elim_saturated_spans": spans_with(a["elim_saturated"]),
            "jj_overflow_spans": spans_with(a["jj_overflow"]),
            "jg_overflow_spans": spans_with(a["jg_overflow"]),
            "ring_high": max(pull_degree_max(s) for s in states),
            "pp_headroom": cap - int(a["append_ptr"].max())}
    assert rec.counters == {0: want}
    assert want["switches"] > 0 and want["eliminations"] > 0


def with_fourth_jj_edge(state):
    """The state with one more jj edge into a junction of lane 0 that has
    three already: a column past the live ones, the cursor moved."""
    s = state.map(torch.clone)
    E_pp = s.E_pp if s.E_pp.dim() == 2 else s.E_pp[0]
    n_pp = s.n_pp if s.n_pp.dim() == 0 else s.n_pp[0]
    live = E_pp[0] >= 0
    dst = E_pp[1][live]
    full = int(torch.nonzero(torch.bincount(dst.long()) == 3)[0, 0])
    into = set(E_pp[0][live & (E_pp[1] == full)].tolist())
    src = next(j for j in E_pp[0][live].tolist()
               if j != full and j not in into)
    c = int(n_pp)
    E_pp[0, c], E_pp[1, c] = src, full
    n_pp += 1
    return s


@pytest.mark.parametrize("mode", MODES)
def test_a_fourth_jj_edge_is_flagged_and_counted(lanes, mode):
    """A junction with four incoming jj edges sets the span's jj_overflow
    (the connect table keeps three), the recorded build counts it, and the
    build does not raise."""
    st = with_fourth_jj_edge(start(lanes, mode))
    with torch.no_grad(), profiling.recording() as rec:
        _, aux = rollout(lanes, mode, n_steps=1)(st)
    assert bool(aux["jj_overflow"][0])
    assert not bool(aux["jg_overflow"][0])
    assert rec.counters[0]["jj_overflow_spans"] == 1
    assert rec.counters[0]["jg_overflow_spans"] == 0
