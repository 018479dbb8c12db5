"""Whether the timed path's output is correct: one build of the window,
every span of it, held against the plain reference (reference/).

The rollout is chaotic through its discrete events: a switch probability
within rounding of the threshold flips an edit, and the trajectories part.
So the reference follows the program span by span from the program's own
state, and checks each stage that this skips by itself:

- joint_gap, darea_gap, switch_prob_gap: the reference's forwards on the
  state a span starts from, every lane of spans drawn from the seed,
  against the program's
  predictions: each head's largest gap over live rows, over the head's
  largest reference value (the switch logits as probabilities).
- topology_mismatch: the span's edit and finalize stages, by the reference
  on (span, lane) pairs drawn from the seed, every lane at least once, from
  the same starting state and the program's own
  predictions, against the program's next state and events: integer
  entries that differ (edge lists, masks, the jj count, grain events,
  switches, extra events), plus each lane's message edges against the
  reference's sample. Exact.
- state_gap: the same pairs' float state (features of live rows), the
  largest gap.
- start_invalid: the start, the build's stacked state, against the lanes'
  own states, and those against the reference's working-out of them from
  the lanes' host graphs (the generator's output, which the reference
  takes as its input). Exact.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict

import numpy as np
import torch

from .reference import graph as ref_graph
from .reference import model as ref_model
from .reference import precision as ref_precision
from .reference import span as ref_span
from .reference import start as ref_start
from .reference import weights as ref_weights

NEG = -1e30
INT_FIELDS = ("E_pp", "E_pq", "mask_g", "mask_j", "n_pp")
EVENT_FIELDS = ("grain_events", "switching", "extra_events")
# the heads whose gap is compared; the regressor's extraV head (a relu)
# reads 0 on every live grain of these states, in the program, the
# reference and the control alike, and is printed only
COMPARED_HEADS = ("joint", "darea", "switch_prob")


@contextlib.contextmanager
def fp32_products():
    """float32 products without TF32, whatever the caller had set."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


class Reference:
    """The reference's weights on `device`, read from the checkpoint files,
    and the configuration's widths and precision."""

    def __init__(self, config: Dict, device):
        self.reg, hp_r = ref_weights.load(config["regressor"], device)
        self.cls, hp_c = ref_weights.load(config["classifier"], device)
        self.C = int(config["hidden"])
        for hp in (hp_r, hp_c):
            if hp["layer_size"] != self.C:
                raise ValueError("checkpoint width differs from the "
                                 "configuration's")

    def forward(self, state, precision: str):
        """The predictions on a [B, ...] state: joint [B, NJ, 2], grain
        [B, NG, 2], grain_area [B, NG], edge_event [B, EP]; and the
        message edges of each lane [B]."""
        r = ref_precision.ROUNDINGS[precision]
        B, NG = state["xg"].shape[:2]
        NJ, EP = state["xj"].shape[1], state["E_pp"].shape[2]
        sample, edges = ref_graph.sample(state)
        with torch.inference_mode(), fp32_products():
            y = ref_model.regressor(self.reg, sample, self.C, r)
            logits = ref_model.classifier(self.cls, sample, self.C, r)
        return ({"joint": y["joint"].reshape(B, NJ, 2),
                 "grain": y["grain"].reshape(B, NG, 2),
                 "grain_area": y["grain_area"].reshape(B, NG),
                 "edge_event": logits.reshape(B, EP)}, edges)


def _lane(state, b):
    return {k: v[b] for k, v in state.items()}


def lane_post_forward(lane, preds, b, config, traffic, r):
    """The reference's post-forward stages of lane b on predictions
    `preds` (a [B, ...] dict)."""
    ed = config["editor"]
    with torch.inference_mode():
        return ref_span.post_forward(
            lane, preds["joint"][b], preds["grain"][b],
            preds["grain_area"][b], preds["edge_event"][b],
            span=traffic["span"], c_threshold=traffic["c_threshold"],
            r_threshold=traffic["r_threshold"], max_elim=ed["max_elim"],
            max_switch=ed["max_switch"], ring=traffic["ring"], r=r)


def _head_gap(prog, ref, live):
    """max |prog - ref| over live rows, over max |ref| there."""
    if not bool(live.any()):
        return 0.0
    d = (prog.float() - ref.float())[live].abs().max()
    scale = ref.float()[live].abs().max().clamp_min(1e-30)
    return float(d / scale)


def forward_gaps(prog, ref, state) -> Dict[str, float]:
    """Each head's gap (_head_gap) on one span's live rows."""
    live_j = state["mask_j"] > 0
    live_g = state["mask_g"] > 0
    live_e = (state["E_pp"][:, 0] >= 0) & (state["E_pp"][:, 1] >= 0)

    def prob(logits):
        return torch.sigmoid(torch.where(live_e, logits.float(),
                                         torch.full_like(logits.float(), NEG)))

    return {"joint": _head_gap(prog["joint"], ref["joint"], live_j),
            "darea": _head_gap(prog["grain"][..., 0], ref["grain"][..., 0],
                               live_g),
            "extrav": _head_gap(prog["grain"][..., 1], ref["grain"][..., 1],
                                live_g),
            "switch_prob": _head_gap(prob(prog["edge_event"]),
                                     prob(ref["edge_event"]), live_e)}


def _mismatches(a, b) -> int:
    a, b = torch.as_tensor(a), torch.as_tensor(b).to(torch.as_tensor(a).device)
    if a.shape != b.shape:
        return max(a.numel(), b.numel(), 1)
    return int((a.long() != b.long()).sum())


def lane_gaps(prog_next, prog_aux, b, ref_next, ref_events):
    """(integer mismatches, float gap) of lane b's next state and events."""
    n = sum(_mismatches(prog_next[f][b], ref_next[f]) for f in INT_FIELDS)
    n += sum(_mismatches(prog_aux[f][b], ref_events[f])
             for f in EVENT_FIELDS)
    gap = 0.0
    for f, mask in (("xg", "mask_g"), ("xj", "mask_j")):
        live = (ref_next[mask] > 0) & (prog_next[mask][b] > 0)
        if bool(live.any()):
            d = (prog_next[f][b][live].float() - ref_next[f][live].float())
            gap = max(gap, float(d.abs().max()))
    return n, gap


def _padded_mismatches(t, s, fill, axis: int) -> int:
    """Entries of t that differ from s in its leading part along `axis`,
    or from `fill` past it."""
    t = t.cpu()
    s = (s.cpu() if torch.is_tensor(s) else torch.from_numpy(np.asarray(s))
         ).to(t.dtype)
    n = s.shape[axis]
    if n > t.shape[axis] or t.dim() != s.dim():
        return max(s.numel(), 1)
    head, tail = t.narrow(axis, 0, n), t.narrow(axis, n, t.shape[axis] - n)
    if head.shape != s.shape:
        return max(s.numel(), 1)
    return int((head != s).sum()) + int((tail != fill).sum())


def start_invalid(start, singles, graphs) -> int:
    """Entries of the build's stacked start that differ from each lane's
    own state padded, and of each lane's state that differ from the
    reference's working-out of it from the lane's host graph
    (reference/start.py), over all lanes."""
    fills = {"xg": (0, 0), "xj": (0, 0), "E_pp": (-1, 1), "E_pq": (-1, 1),
             "mask_g": (0, 0), "mask_j": (0, 0)}       # (fill, axis)
    bad = 0
    for b, (single, graph) in enumerate(zip(singles, graphs)):
        ref = ref_start.lane_state(*graph)
        for f, (fill, axis) in fills.items():
            bad += _padded_mismatches(start[f][b], single[f], fill, axis)
            bad += _padded_mismatches(single[f], ref[f], fill, axis)
        bad += int(int(single["n_pp"]) != int(start["n_pp"][b]))
        bad += int(int(single["n_pp"]) != ref["n_pp"])
    return bad


def sampled_pairs(spans: int, lanes: int, per_lane: int, seed: int):
    """(span, lane) pairs drawn from the seed: per_lane spans of every
    lane, without repeats."""
    rng = np.random.default_rng(seed)
    k = min(per_lane, spans)
    return sorted((int(s), lane) for lane in range(lanes)
                  for s in rng.choice(spans, size=k, replace=False))


def sampled_spans(spans: int, n: int, seed: int):
    """n of the build's spans drawn from the seed."""
    rng = np.random.default_rng(seed + 1)
    return sorted(int(i) for i in rng.choice(spans, size=min(n, spans),
                                             replace=False))


def check_spans(records, ref: Reference, config, traffic, pairs,
                precision: str, forward_spans=None) -> Dict:
    """The numbers of a build's recorded spans: each compared head's gap
    over every lane of `forward_spans` (every span where None; every
    head's under "heads"),
    topology_mismatch and state_gap over the (span, lane) pairs; and the
    seconds each part took."""
    heads: Dict[str, float] = {}
    topo, gap = 0, 0.0
    t_fwd = t_post = 0.0
    for i, rec in enumerate(records):
        t0 = time.perf_counter()
        state = rec["state"]
        prog = dict(rec["y_r"], edge_event=rec["y_c"]["edge_event"])
        if forward_spans is None or i in forward_spans:
            y_ref, edges = ref.forward(state, precision)
            for k, v in forward_gaps(prog, y_ref, state).items():
                heads[k] = max(heads.get(k, 0.0), v)
            topo += _mismatches(
                rec["aux"]["message_edges"].round().long(), edges.long())
        t1 = time.perf_counter()
        for b in (lane for span, lane in pairs if span == i):
            nxt, events, overflow = lane_post_forward(
                _lane(state, b), prog, b, config, traffic, ref_precision.fp32)
            n, g = lane_gaps(rec["next"], rec["aux"], b, nxt, events)
            topo += n + int(bool(rec["aux"]["pp_overflow"][b]) != overflow)
            gap = max(gap, g)
        t_fwd += t1 - t0
        t_post += time.perf_counter() - t1
    out = {f"{k}_gap": heads.get(k, float("nan")) for k in COMPARED_HEADS}
    out.update(topology_mismatch=topo, state_gap=gap, heads=heads,
               seconds={"forward": t_fwd, "post": t_post})
    return out


def judge(numbers: Dict, limits: Dict) -> bool:
    """Every number at or under its limit (and a number at all)."""
    return all(k in numbers and np.isfinite(numbers[k])
               and numbers[k] <= limits[k] for k in limits)
