"""The output check on the CPU at a small size (two 40 um lanes, three
spans; the port takes its plain versions): a sound run is correct, and the
control (the reference at the precision below the configuration's, put in
the program's place) and every fault planted under the timed path read
not correct."""

import time

import pytest

from portbench import check, control, faults, run, spec

CELLS = ("fp32-hex64x120", "bf16-hex64x120")
SEED = 2 ** 31 + 77


def small(name):
    cell = spec.cell(name)
    cell.traffic.update(lanes=2, lxd=40, spans=3, check_lane_spans=3,
                        check_spans=3)
    return cell


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    result, lines = run.run_cell(small(name), SEED, 0.1, False, "cpu",
                                 time.perf_counter())
    assert result["correct"], lines
    assert list(result)[-1] == "check"
    assert result["metrics"]["edges_per_s"]["value"] > 0
    assert lines[-len(result["check"]):] == [
        f"{k} {v['value']} limit {v['limit']}"
        for k, v in result["check"].items()]


@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_is_not_correct(name, fault):
    result, lines = run.run_cell(small(name), SEED, 0.1, False, "cpu",
                                 time.perf_counter(),
                                 fault=faults.FAULTS[fault])
    assert not result["correct"], lines


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    cell = small(name)
    cfg, traffic = cell.config, cell.traffic
    start, _ = control.traffic_mod.starting_state(
        control.traffic_mod.lane_graphs(traffic, SEED), "cpu")
    ref = check.Reference(cfg, "cpu")
    records = control.control_records(control.system.state_dict(start), ref,
                                      cfg, traffic)
    pairs = check.sampled_pairs(3, 2, 3, SEED)
    numbers = check.check_spans(records, ref, cfg, traffic, pairs,
                                cfg["precision"])
    numbers.update(start_invalid=0, launch_mismatch=0)
    assert not check.judge(numbers, cfg["limits"]), numbers
