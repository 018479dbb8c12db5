"""Hyperparameter configuration with the mixed-radix `model_id` grid decode
(the model filename encodes its config)."""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from ..graph import schema


@dataclasses.dataclass
class HyperParams:
    model_type: str              # 'regressor' | 'classifier'
    model_id: int
    lr: float
    layer_size: int              # hidden channels C
    batch_size: int
    decay_step: int
    epoch: int
    frames: int
    window: int = 1
    out_win: int = 1
    layers: int = 1
    weight_decay: float = 0.0
    bias: bool = True
    pos_weight: float = 1.0      # classifier BCE positive-class weight
    lr_1: float = 1.0            # transfer-learning LR multipliers
    lr_2: float = 1.0
    transfer: bool = False
    history: bool = False
    edge_len: bool = False
    in_grain: int = schema.GRAIN_DIM
    in_joint: int = schema.JOINT_DIM
    n_grain_targets: int = len(schema.GRAIN_TARGETS)
    n_joint_targets: int = len(schema.JOINT_TARGETS)

    @property
    def cell_kinds(self) -> Tuple[str, ...]:
        return ("pgclstm",) + ("sage",) * (self.layers - 1)


def _decode(model_id: int, grid: Dict[str, List]) -> Dict:
    """Mixed-radix decode in insertion order."""
    out = {}
    prev_dim = 1
    for name, values in grid.items():
        cur_dim = prev_dim * len(values)
        out[name] = values[(model_id % cur_dim) // prev_dim]
        prev_dim = cur_dim
    return out


def regressor(model_id: int = 0, **overrides) -> HyperParams:
    """model_id 0 is the shipped config: lr 5e-3, hidden 96, batch 4,
    decay 10."""
    grid = {
        "lr": [50e-4, 10e-4, 20e-4],
        "layer_size": [96, 64, 32],
        "batch_size": [4, 2, 8, 16],
        "decay_step": [10, 5, 20],
    }
    d = _decode(model_id, grid)
    hp = HyperParams(
        model_type="regressor", model_id=model_id, lr=d["lr"],
        layer_size=d["layer_size"], batch_size=d["batch_size"],
        decay_step=d["decay_step"], epoch=50, frames=21, window=1,
    )
    return dataclasses.replace(hp, **overrides)


def classifier(model_id: int = 0, **overrides) -> HyperParams:
    """From-scratch classifier grid."""
    grid = {
        "pos_weight": [1, 2, 4, 8],
        "batch_size": [2, 4, 8, 16],
        "lr": [100e-4, 25e-4, 50e-4],
        "decay_step": [10, 5, 20],
        "hidden": [32, 24, 16],
    }
    d = _decode(model_id, grid)
    hp = HyperParams(
        model_type="classifier", model_id=model_id, lr=d["lr"],
        layer_size=32, batch_size=d["batch_size"],
        decay_step=d["decay_step"], epoch=60, frames=13,
        pos_weight=float(d["pos_weight"]),
    )
    return dataclasses.replace(hp, **overrides)


def classifier_transfered(model_id: int = 0, **overrides) -> HyperParams:
    """model_id 1 is the shipped config: lr 2.5e-3, hidden 96, batch 32,
    window 3, 20 epochs."""
    grid = {
        "pos_weight": [1],
        "batch_size": [32],
        "lr": [100e-4, 25e-4, 5e-4],
    }
    d = _decode(model_id, grid)
    hp = HyperParams(
        model_type="classifier", model_id=model_id, lr=d["lr"],
        layer_size=96, batch_size=d["batch_size"], decay_step=10,
        epoch=20, frames=13, window=3, pos_weight=float(d["pos_weight"]),
        transfer=True,
    )
    return dataclasses.replace(hp, **overrides)
