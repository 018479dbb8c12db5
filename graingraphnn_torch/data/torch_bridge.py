"""The port's models <-> the reference PyTorch code's state_dict layout.

Maps the port's fused-gate modules (models/cells.py, models/grain_nn.py)
to and from the reference's `state_dict` (its GrainNN_regressor and
GrainNN_classifier, four HeteroConv modules per cell), so that weights
trained here load into the reference's model code, and its `.pt`
checkpoints into the port. A numpy copy of the JAX package's mapping
(data/torch_bridge.py there), applied to the port's parameter tree
(train.checkpoint.params_to_jax / params_from_jax).

Gate packing: the reference keeps four independent HeteroConv modules
(conv_i/f/c/o); here the four gates are fused along the output axis in
order (i, f, c, o) (cells.GATE_ORDER). Per edge type and gate g:

    ours key.w[:, g*C:(g+1)*C]   =  theirs conv_g.convs.<et>.lin_key.weight.T
    ours l2.w[g]                 =  theirs lin_l2.weight.T    ([in, out])
    ours edge.w[g*C:(g+1)*C]     =  theirs lin_edge.weight[:, 0]
    ours bias[<nt>][g]           =  theirs b_g.<nt>[0]

Only the shipped configuration space is bridged: layers == 1,
history=False, edge_len=False (the reference's edge_len head is declared
with an input width its own forward never produces, and its history LSTM
is off in every shipped model).
"""

from __future__ import annotations

import sys
from collections import OrderedDict
from pathlib import Path
from typing import Dict

import numpy as np
import torch
from torch import nn

from ..models.cells import GATE_ORDER
from ..models.hyper import HyperParams
from ..train import checkpoint

REPO_ROOT = Path(__file__).resolve().parents[2]
PYGSHIM_DIR = REPO_ROOT / "tools" / "pygshim"

# the port's conv-dict key -> the reference ModuleDict key ('__'.join(edge_type))
EDGE_KEY_TO_REF = {
    "push": "grain__push__joint",
    "pull": "joint__pull__grain",
    "connect": "joint__connect__joint",
}

_STACKS = (("encoder", "gclstm_encoder"), ("decoder", "gclstm_decoder"))


def ensure_reference_importable(reference_dir: Path):
    """Put the PyG shim and the reference checkout at `reference_dir` on
    sys.path (shim first so `import torch_geometric` resolves to
    tools/pygshim). The caller names the checkout; there is no default."""
    for p in (str(PYGSHIM_DIR), str(reference_dir)):
        if p not in sys.path:
            sys.path.insert(0, p)


def _t(a) -> np.ndarray:
    return np.asarray(a, dtype=np.float32)


def _check_layers(hp: HyperParams):
    if hp.layers != 1:
        raise NotImplementedError(
            "torch bridge covers the shipped configs (layers == 1); the "
            "reference SAGE cells for layers >= 2 carry dead W_* parameters "
            "with no counterpart here")
    if hp.history or hp.edge_len:
        raise NotImplementedError("bridge covers history=False, edge_len=False")


def _export_cell(sd: OrderedDict, prefix: str, cell: Dict, C: int):
    """One fused HeteroPGCLSTM cell -> reference cell state_dict entries."""
    for g, gate in enumerate(GATE_ORDER):
        lo, hi = g * C, (g + 1) * C
        for my_key, ref_key in EDGE_KEY_TO_REF.items():
            conv = cell["conv"][my_key]
            base = f"{prefix}.conv_{gate}.convs.{ref_key}"
            for name in ("key", "query", "value", "l2", "edge", "skip"):
                w, b = conv[name]["w"], conv[name].get("b")
                if name == "l2":
                    w, b = w[g].T, b[g]
                elif name == "edge":
                    w, b = w[lo:hi][:, None], None
                else:
                    w, b = w[:, lo:hi].T, b[lo:hi]
                sd[f"{base}.lin_{name}.weight"] = _t(w)
                if b is not None:
                    sd[f"{base}.lin_{name}.bias"] = _t(b)
        for nt in ("grain", "joint"):
            sd[f"{prefix}.b_{gate}.{nt}"] = _t(cell["bias"][nt][g])[None, :]


def _import_cell(sd: Dict, prefix: str, C: int, in_grain: int, in_joint: int):
    """Reference cell state_dict entries -> one fused cell's numpy tree."""
    fan = {"push": in_grain + C, "pull": in_joint + C, "connect": in_joint + C}
    dst_fan = {"push": in_joint + C, "pull": in_grain + C,
               "connect": in_joint + C}
    conv = {}
    for my_key, ref_key in EDGE_KEY_TO_REF.items():
        widths = {"key": fan[my_key], "value": fan[my_key],
                  "query": dst_fan[my_key], "skip": dst_fan[my_key]}
        c = {n: {"w": np.zeros((f, 4 * C), np.float32),
                 "b": np.zeros(4 * C, np.float32)} for n, f in widths.items()}
        c["l2"] = {"w": np.zeros((4, C, C), np.float32),
                   "b": np.zeros((4, C), np.float32)}
        c["edge"] = {"w": np.zeros(4 * C, np.float32)}
        for g, gate in enumerate(GATE_ORDER):
            lo, hi = g * C, (g + 1) * C
            base = f"{prefix}.conv_{gate}.convs.{ref_key}"
            for name in widths:
                c[name]["w"][:, lo:hi] = _t(sd[f"{base}.lin_{name}.weight"]).T
                c[name]["b"][lo:hi] = _t(sd[f"{base}.lin_{name}.bias"])
            c["l2"]["w"][g] = _t(sd[f"{base}.lin_l2.weight"]).T
            c["l2"]["b"][g] = _t(sd[f"{base}.lin_l2.bias"])
            c["edge"]["w"][lo:hi] = _t(sd[f"{base}.lin_edge.weight"])[:, 0]
        conv[my_key] = c
    bias = {}
    for nt in ("grain", "joint"):
        b = np.zeros((4, C), np.float32)
        for g, gate in enumerate(GATE_ORDER):
            b[g] = _t(sd[f"{prefix}.b_{gate}.{nt}"])[0]
        bias[nt] = b
    return {"conv": conv, "bias": bias}


def _linear_out(sd: OrderedDict, name: str, p: Dict):
    sd[f"{name}.weight"] = _t(p["w"]).T
    sd[f"{name}.bias"] = _t(p["b"])


def _linear_in(sd: Dict, name: str) -> Dict:
    return {"w": _t(sd[f"{name}.weight"]).T.copy(),
            "b": _t(sd[f"{name}.bias"]).copy()}


def _heads(hp: HyperParams):
    if hp.model_type == "regressor":
        return (("head", "grain", "linear.grain"),
                ("head", "joint", "linear.joint"))
    return (("lin1", None, "lin1"), ("lin2", None, "lin2"))


def to_state_dict(model: nn.Module) -> OrderedDict:
    """The port's regressor or classifier -> the reference model's
    state_dict (numpy values; `to_torch` makes tensors)."""
    hp = model.hp
    _check_layers(hp)
    tree = checkpoint.params_to_jax(model)
    sd: OrderedDict = OrderedDict()
    for mine, theirs in _STACKS:
        _export_cell(sd, f"{theirs}.cell_list.0", tree[mine][0], hp.layer_size)
    for top, sub, ref in _heads(hp):
        _linear_out(sd, ref, tree[top][sub] if sub else tree[top])
    return sd


def from_state_dict(sd: Dict, hp: HyperParams, device="cpu") -> nn.Module:
    """The reference model's state_dict -> the port's model for hp on
    `device`."""
    _check_layers(hp)
    sd = from_torch(sd)
    tree = {mine: [_import_cell(sd, f"{theirs}.cell_list.0", hp.layer_size,
                                hp.in_grain, hp.in_joint)]
            for mine, theirs in _STACKS}
    for top, sub, ref in _heads(hp):
        if sub:
            tree.setdefault(top, {})[sub] = _linear_in(sd, ref)
        else:
            tree[top] = _linear_in(sd, ref)
    return checkpoint.params_from_jax(tree, hp, device)


def to_torch(sd: OrderedDict) -> OrderedDict:
    """numpy state_dict -> torch tensors (contiguous, float32)."""
    return OrderedDict(
        (k, torch.from_numpy(np.ascontiguousarray(v).copy()))
        for k, v in sd.items())


def from_torch(sd) -> Dict:
    """torch state_dict -> numpy dict (accepts tensors or arrays)."""
    return {k: v.detach().cpu().numpy() if hasattr(v, "detach")
            else np.asarray(v) for k, v in sd.items()}


def save_torch_checkpoint(path: str, model: nn.Module):
    """Write a reference-loadable `.pt` (torch.save of the state_dict)."""
    torch.save(to_torch(to_state_dict(model)), path)


def load_torch_checkpoint(path: str, hp: HyperParams, device="cpu"):
    """Read a reference `.pt` state_dict into the port's model for hp."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return from_state_dict(sd, hp, device)
