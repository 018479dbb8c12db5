"""Faults planted under the timed path, each of which the output check has
to catch (portbench/tests/test_portbench_check.py on the CPU, control.py
on the card). Each is a function of the Program giving a context manager
that breaks the path while it is open. The exchange between chips is not
among them: every cell runs on one chip."""

from __future__ import annotations

import contextlib

import torch

from . import system

ROLLOUT = "graingraphnn_torch.rollout.device_rollout"
NEG = -1e30


def state_unchanged(program):
    """A span returns the state it started from (with its aux)."""
    def make(post_forward_step):
        def unchanged(state, *args, **kwargs):
            _, aux = post_forward_step(state, *args, **kwargs)
            return state, aux
        return unchanged
    return system.patched(ROLLOUT, "post_forward_step", make)


def half_batch(program):
    """The second half of the lanes gets no prediction: their forward's
    output is dropped before the span's later stages."""
    def make(post_forward_step):
        def half(state, y_r, y_c, *args, **kwargs):
            h = state.xg.shape[0] // 2
            y_r = {k: v.clone() for k, v in y_r.items()}
            y_c = {k: v.clone() for k, v in y_c.items()}
            y_r["joint"][h:] = 0.0
            y_r["grain"][h:] = 0.0
            y_r["grain_area"][h:] = state.xg[h:, :, 3]
            y_c["edge_event"][h:] = NEG
            return post_forward_step(state, y_r, y_c, *args, **kwargs)
        return half
    return system.patched(ROLLOUT, "post_forward_step", make)


@contextlib.contextmanager
def prediction_altered(program):
    """One junction's predicted displacement moved by 0.01 where the
    regressor produces it."""
    def hook(_module, _args, out):
        out = dict(out)
        joint = out["joint"].clone()
        joint[0, 0] += 0.01
        out["joint"] = joint
        return out

    handle = program.reg.register_forward_hook(hook)
    try:
        yield
    finally:
        handle.remove()


def edit_altered(program):
    """The first pull edge of every lane moved to another grain where the
    editor produces the span's topology."""
    def make(edit_stage):
        def altered(*args, **kwargs):
            tstate, switching, extra = edit_stage(*args, **kwargs)
            E_pq = tstate.E_pq.clone()
            E_pq[:, 1, 0] = torch.where(E_pq[:, 1, 0] > 0,
                                        E_pq[:, 1, 0] - 1, 1)
            tstate.E_pq = E_pq
            return tstate, switching, extra
        return altered
    return system.patched(ROLLOUT, "edit_stage", make)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "prediction_altered": prediction_altered,
          "edit_altered": edit_altered}
