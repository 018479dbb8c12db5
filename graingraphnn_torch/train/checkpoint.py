"""Checkpoints: `<path>.ckpt` (a pickle of numpy parameter trees in the JAX
package's layout, with the decision threshold under "extra") plus
`<path>.json` (the HyperParams fields). The port writes what the JAX
package's `train.checkpoint.load` reads, and reads what it writes."""

from __future__ import annotations

import dataclasses
import json
import os
import pickle
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..models import grain_nn
from ..models.hyper import HyperParams


class _NumpyUnpickler(pickle.Unpickler):
    """Pickles written under numpy 2 name `numpy._core.*`; numpy 1.x calls
    the same modules `numpy.core.*`. Anything outside numpy and the
    standard containers is refused, so a checkpoint cannot pull in JAX."""

    def find_class(self, module, name):
        if module.startswith("numpy._core") and not hasattr(np, "_core"):
            module = "numpy.core" + module[len("numpy._core"):]
        if module.split(".")[0] not in ("numpy", "builtins", "collections"):
            raise pickle.UnpicklingError(f"checkpoint names {module}.{name}")
        return super().find_class(module, name)


def load_pickle(path: str):
    """A pickle of numpy arrays in standard containers (a checkpoint, or
    cli.extract's dataset), read through _NumpyUnpickler."""
    with open(path, "rb") as f:
        return _NumpyUnpickler(f).load()


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_torch(v) for v in tree]
    return torch.from_numpy(np.array(tree, np.float32))


def load(path: str) -> Tuple[Any, HyperParams, Dict[str, Any]]:
    """Returns (params, hp, extra): params is the JAX package's parameter
    tree with float32 CPU tensors as leaves."""
    payload = load_pickle(path + ".ckpt")
    return _to_torch(payload["params"]), load_hp(path), payload.get("extra", {})


def load_hp(path: str) -> HyperParams:
    """The HyperParams of <path>.json."""
    with open(path + ".json") as f:
        return HyperParams(**json.load(f))


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: tree}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}."))
    return out


def params_from_jax(tree, hp: HyperParams, device="cuda") -> nn.Module:
    """The port's model for `hp` holding the weights of a JAX parameter tree
    (numpy arrays or tensors as leaves, the JAX layout kept: w [F, G*C],
    l2.w [G, C, C], edge.w [G*C]). The tree must name every parameter of
    the model and nothing else."""
    model = grain_nn.build(hp)
    flat = _flatten(tree)
    params = dict(model.named_parameters())
    if set(flat) != set(params):
        raise ValueError(
            f"parameter trees differ: {sorted(set(flat) ^ set(params))}")
    with torch.no_grad():
        for name, p in params.items():
            v = flat[name]
            v = (v.detach().cpu().float() if isinstance(v, torch.Tensor)
                 else torch.from_numpy(np.array(v, np.float32)))
            if v.shape != p.shape:
                raise ValueError(f"{name}: {tuple(v.shape)} != {tuple(p.shape)}")
            p.copy_(v)
    return model.to(device)


def params_to_jax(model: nn.Module):
    """The inverse of params_from_jax: the JAX package's tree layout with
    numpy leaves (lists for the encoder/decoder stacks)."""
    tree: Dict[str, Any] = {}
    for name, p in model.named_parameters():
        parts = name.split(".")
        cur = tree
        for part, nxt in zip(parts, parts[1:]):
            if isinstance(cur, list):
                part = int(part)
                cur.extend({} for _ in range(part + 1 - len(cur)))
            elif part not in cur:
                cur[part] = [] if nxt.isdigit() else {}
            cur = cur[part]
        cur[parts[-1]] = p.detach().cpu().numpy()
    return tree


def load_model(path: str, device="cuda"):
    """(model, hp, extra) for a checkpoint pair on `device`."""
    tree, hp, extra = load(path)
    return params_from_jax(tree, hp, device), hp, extra


def save(path: str, model: nn.Module, hp: HyperParams,
         extra: Optional[Dict[str, Any]] = None):
    """Writes <path>.ckpt ({"params": the JAX tree with numpy leaves,
    "extra": extra}) and <path>.json (hp)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"params": params_to_jax(model)}
    if extra:
        payload["extra"] = dict(extra)
    with open(path + ".ckpt", "wb") as f:
        pickle.dump(payload, f)
    with open(path + ".json", "w") as f:
        json.dump(dataclasses.asdict(hp), f, indent=1)
