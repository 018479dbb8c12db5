"""The readings that the output check's limits are set from, at a cell's own
size, on the card:

    python3 -m portbench.control --workload <cell> --seeds 1,2,... \\
        --control-seeds 1,2,3

For every seed, one build of the program as the window runs it, held
against the reference (check.py): the lower readings. For each control
seed also the control, the reference put in the program's place at the
precisions below the configuration's (its "control" key: the forward's
products, and the float32 elementwise stages), and each planted fault of
faults.py: the upper readings. One JSON line a reading. The benchmark's
own runs do not run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from . import check, faults, spec, system
from . import traffic as traffic_mod
from .reference import precision as ref_precision


def control_records(start, ref, config, traffic):
    """A build's spans computed by the reference at the control's
    precisions, in the Recorder's form."""
    low = config["control"]
    r_post = ref_precision.ROUNDINGS[low["post"]]
    state = dict(start)
    B = state["xg"].shape[0]
    records = []
    for _ in range(traffic["spans"]):
        y, edges = ref.forward(state, low["forward"])
        lanes = [check.lane_post_forward(check._lane(state, b), y, b, config,
                                         traffic, r_post) for b in range(B)]
        nxt = {f: torch.stack([torch.as_tensor(n[f], device=y["joint"].device)
                               for n, _, _ in lanes])
               for f in system.STATE_FIELDS}
        aux = {f: torch.stack([e[f] for _, e, _ in lanes])
               for f in check.EVENT_FIELDS}
        aux["message_edges"] = edges.float()
        aux["pp_overflow"] = torch.tensor([o for _, _, o in lanes])
        records.append({"state": state, "y_r": {k: y[k] for k in
                                                ("joint", "grain",
                                                 "grain_area")},
                        "y_c": {"edge_event": y["edge_event"]},
                        "next": nxt, "aux": aux})
        state = nxt
    return records


def program_records(program, start, fault=None):
    """One build of the program, recorded (with a planted fault)."""
    recorder = system.Recorder()
    broken = fault(program) if fault else contextlib.nullcontext()
    with torch.no_grad(), broken, recorder.recording():
        program.run(start)
    return recorder.spans


def readings(cell, seed: int, with_controls: bool):
    cfg, traffic = cell.config, cell.traffic
    device = "cuda"
    with torch.no_grad():
        program = system.Program(cfg, traffic, device)
        start, _ = traffic_mod.starting_state(
            traffic_mod.lane_graphs(traffic, seed), device)
        program.run(start)
    ref = check.Reference(cfg, device)
    pairs = check.sampled_pairs(traffic["spans"], traffic["lanes"],
                                traffic["check_lane_spans"], seed)

    def numbers(records):
        t = time.perf_counter()
        out = check.check_spans(records, ref, cfg, traffic, pairs,
                                cfg["precision"], check.sampled_spans(
                                    traffic["spans"], traffic["check_spans"],
                                    seed))
        out["check_s"] = time.perf_counter() - t
        return out

    yield "program", numbers(program_records(program, start))
    if not with_controls:
        return
    t = time.perf_counter()
    records = control_records(system.state_dict(start), ref, cfg, traffic)
    out = numbers(records)
    out["control_s"] = time.perf_counter() - t
    yield "control", out
    for name, fault in faults.FAULTS.items():
        yield name, numbers(program_records(program, start, fault))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    cell = spec.cell(args.workload)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")]
    seeds += sorted(controls - set(seeds))
    for seed in seeds:
        for kind, nums in readings(cell, seed, seed in controls):
            print(json.dumps({"workload": cell.name, "seed": seed,
                              "reading": kind, **nums}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
