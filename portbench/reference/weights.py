"""The shipped checkpoints read from their files: `<path>.ckpt`, a pickle of
numpy parameter trees in the JAX package's layout, and `<path>.json`, the
model's hyperparameters."""

from __future__ import annotations

import json
import pickle

import numpy as np
import torch


class _NumpyUnpickler(pickle.Unpickler):
    """Numpy arrays in standard containers and nothing else."""

    def find_class(self, module, name):
        if module.startswith("numpy._core") and not hasattr(np, "_core"):
            module = "numpy.core" + module[len("numpy._core"):]
        if module.split(".")[0] not in ("numpy", "builtins", "collections"):
            raise pickle.UnpicklingError(f"checkpoint names {module}.{name}")
        return super().find_class(module, name)


def _tensors(tree, device):
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tensors(v, device) for v in tree]
    return torch.from_numpy(np.array(tree, np.float32)).to(device)


def load(path: str, device) -> tuple:
    """(params, hp): the parameter tree with float32 tensors on `device`,
    and the hyperparameters as a dict."""
    with open(path + ".ckpt", "rb") as f:
        payload = _NumpyUnpickler(f).load()
    with open(path + ".json") as f:
        hp = json.load(f)
    return _tensors(payload["params"], device), hp
