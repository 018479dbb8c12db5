"""The system under test, graingraphnn_torch, as the harness drives it: its
two checkpoints on the card, the batched rollout of a cell, its launch
counters, and what the harness hangs on its entry points by name (a
recorder of one build's spans for the output check; record_function
ranges, in traced runs only).

Every name is looked up on the port's modules when it is wrapped; a
missing one raises."""

from __future__ import annotations

import contextlib
from typing import Dict, List

import torch

STATE_FIELDS = ("xg", "xj", "E_pp", "E_pq", "mask_g", "mask_j", "n_pp")
# the port's entry points that the traced run wraps in ranges:
# (module, function, range name)
RANGES = (
    ("graingraphnn_torch.rollout.device_rollout", "batched_step", "span"),
    ("graingraphnn_torch.rollout.device_rollout", "_pack_build_sample",
     "sample"),
    ("graingraphnn_torch.models.cells", "apply_period_conv", "conv"),
    ("graingraphnn_torch.rollout.device_rollout", "post_forward_step",
     "post"),
    ("graingraphnn_torch.rollout.device_rollout", "edit_stage", "edit"),
)
FORWARD_RANGE = "forward"    # forward hooks on the regressor and classifier


def state_dict(state) -> Dict[str, torch.Tensor]:
    """The fields of a DeviceRolloutState that a static span reads and
    writes."""
    return {f: getattr(state, f) for f in STATE_FIELDS}


class Program:
    """The two models of a configuration on `device` and the rollout of a
    traffic mix."""

    def __init__(self, config: Dict, traffic: Dict, device):
        from graingraphnn_torch.rollout import device_rollout as dr
        from graingraphnn_torch.train import checkpoint

        self.reg, hp_r, _ = checkpoint.load_model(config["regressor"], device)
        self.cls, hp_c, _ = checkpoint.load_model(config["classifier"],
                                                  device)
        for hp, window in ((hp_r, config["regressor_window"]),
                           (hp_c, config["classifier_window"])):
            got = (hp.layer_size, hp.layers, hp.in_grain, hp.in_joint,
                   hp.window, hp.history)
            want = (config["hidden"], config["layers"], config["in_grain"],
                    config["in_joint"], window, False)
            if got != want:
                raise ValueError(f"checkpoint {hp.model_type}: (hidden, "
                                 f"layers, in_grain, in_joint, window, "
                                 f"history) {got}, configuration {want}")
        self.run = dr.make_rollout_batched(
            self.reg, self.cls, n_steps=traffic["spans"],
            span=traffic["span"], ring=traffic["ring"],
            c_threshold=traffic["c_threshold"],
            r_threshold=traffic["r_threshold"], pallas=config["pallas"])


def reset_launches():
    from graingraphnn_torch.kernels import edge_stage, editor_fused

    edge_stage.reset_counts()
    editor_fused.launches = 0


def launches() -> Dict[str, int]:
    """Kernel launches since reset_launches(), by kernel and precision."""
    from graingraphnn_torch.kernels import edge_stage, editor_fused

    return {"node_proj": edge_stage.launches["node_proj"],
            "edge_attn": edge_stage.launches["edge_attn"],
            "node_proj_bf16": edge_stage.bf16_launches["node_proj"],
            "edge_attn_bf16": edge_stage.bf16_launches["edge_attn"],
            "editor": editor_fused.launches}


def expected_launches(precision: str, spans: int, on_card: bool):
    """12 + 12 conv launches of the configuration's precision and one
    editor launch a span on the card (2 models x 2 cells x 3 convs); on
    the CPU the port takes its plain versions and launches nothing."""
    want = dict.fromkeys(("node_proj", "edge_attn", "node_proj_bf16",
                          "edge_attn_bf16", "editor"), 0)
    if on_card:
        suffix = "_bf16" if precision == "bf16" else ""
        want["node_proj" + suffix] = want["edge_attn" + suffix] = 12 * spans
        want["editor"] = spans
    return want


def _module(name):
    import importlib

    return importlib.import_module(name)


@contextlib.contextmanager
def patched(module_name: str, attr: str, make):
    """module.attr replaced by make(original) inside the block."""
    module = _module(module_name)
    original = getattr(module, attr)     # a missing name raises here
    if not callable(original):
        raise TypeError(f"{module_name}.{attr} is not callable")
    setattr(module, attr, make(original))
    try:
        yield
    finally:
        setattr(module, attr, original)


class Recorder:
    """Keeps every span of the builds run inside `recording()`: the state a
    span starts from, the forward's predictions and the span's next state
    and aux, as the port's post_forward_step sees and returns them."""

    def __init__(self):
        self.spans: List[Dict] = []

    def wrap(self, post_forward_step):
        def recorded(state, y_r, y_c, *args, **kwargs):
            new_state, aux = post_forward_step(state, y_r, y_c, *args,
                                               **kwargs)
            self.spans.append({"state": state_dict(state),
                               "y_r": dict(y_r), "y_c": dict(y_c),
                               "next": state_dict(new_state), "aux": aux})
            return new_state, aux
        return recorded

    def recording(self):
        return patched("graingraphnn_torch.rollout.device_rollout",
                       "post_forward_step", self.wrap)


class Ranges:
    """record_function ranges around the port's entry points (RANGES) and
    its two models' forwards, and a log of every conv call's shapes."""

    def __init__(self, program: Program):
        self.program = program
        self.convs: List[Dict] = []

    def _ranged(self, name):
        def make(fn):
            def ranged(*args, **kwargs):
                with torch.profiler.record_function(name):
                    return fn(*args, **kwargs)
            return ranged
        return make

    def _conv(self, fn):
        ranged = self._ranged("conv")(fn)

        def logged(conv, x_src, x_dst, nbr, edge_len, nbr_mask, **kw):
            self.convs.append({
                "ns": x_src.shape[0], "f_src": x_src.shape[1],
                "nd": x_dst.shape[0], "f_dst": x_dst.shape[1],
                "k": nbr.shape[1], "gates": kw["num_gates"],
                "channels": kw["out_channels"]})
            return ranged(conv, x_src, x_dst, nbr, edge_len, nbr_mask, **kw)
        return logged

    @contextlib.contextmanager
    def installed(self):
        with contextlib.ExitStack() as stack:
            for module, attr, name in RANGES:
                make = self._conv if name == "conv" else self._ranged(name)
                stack.enter_context(patched(module, attr, make))
            for model in (self.program.reg, self.program.cls):
                open_ranges = []

                def pre(_m, _a, open_ranges=open_ranges):
                    rf = torch.profiler.record_function(FORWARD_RANGE)
                    rf.__enter__()
                    open_ranges.append(rf)

                def post(_m, _a, _o, open_ranges=open_ranges):
                    open_ranges.pop().__exit__(None, None, None)

                stack.callback(model.register_forward_pre_hook(pre).remove)
                stack.callback(model.register_forward_hook(post).remove)
            yield self
