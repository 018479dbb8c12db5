"""Checkpoints: `<path>.ckpt` (a pickle of numpy parameter trees in the JAX
package's layout, with the decision threshold under "extra" and, to
resume a run, the optimizer's and the schedule's state under
"opt_state") plus `<path>.json` (the HyperParams fields). The port writes
what the JAX package's `train.checkpoint.load` reads, and reads what it
writes. `opt_state_from_jax` carries an optax Adam state into a torch
Adam, as `params_from_jax` carries the weights."""

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


def load(path: str, *, opt_state: bool = False):
    """Returns (params, hp, extra): params is the JAX package's parameter
    tree with float32 CPU tensors as leaves. With opt_state=True, (params,
    hp, extra, the saved optimizer state or None) (restore it with
    restore_opt_state)."""
    payload = load_pickle(path + ".ckpt")
    out = (_to_torch(payload["params"]), load_hp(path),
           payload.get("extra", {}))
    return out + (payload.get("opt_state"),) if opt_state else out


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
         extra: Optional[Dict[str, Any]] = None, *, opt_state=None):
    """Writes <path>.ckpt ({"params": the JAX tree with numpy leaves,
    "extra": extra, "opt_state": opt_state}) and <path>.json (hp).
    opt_state is opt_state_of's tree (numpy leaves)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"params": params_to_jax(model)}
    if extra:
        payload["extra"] = dict(extra)
    if opt_state is not None:
        payload["opt_state"] = opt_state
    with open(path + ".ckpt", "wb") as f:
        pickle.dump(payload, f)
    with open(path + ".json", "w") as f:
        json.dump(dataclasses.asdict(hp), f, indent=1)


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_numpy_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return tree


def _tensor_tree(tree):
    if isinstance(tree, dict):
        return {k: _tensor_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tensor_tree(v) for v in tree)
    if isinstance(tree, np.ndarray):
        return torch.from_numpy(tree.copy())
    return tree


def opt_state_of(opt, sched=None, **extra) -> Dict[str, Any]:
    """The optimizer's and the schedule's state_dicts with numpy arrays
    for tensors (and `extra`, e.g. the epoch), as save(opt_state=) takes
    it."""
    out = {"optimizer": _numpy_tree(opt.state_dict()), **extra}
    if sched is not None:
        out["scheduler"] = _numpy_tree(sched.state_dict())
    return out


def restore_opt_state(opt, sched, saved: Dict[str, Any]):
    """Load opt_state_of's tree into the optimizer (its state moves to the
    parameters' devices) and the schedule."""
    opt.load_state_dict(_tensor_tree(saved["optimizer"]))
    if sched is not None and "scheduler" in saved:
        sched.load_state_dict(saved["scheduler"])


def _adam_states(tree):
    """The optax Adam states (objects with count, mu and nu) in an optax
    state tree, found by their fields, in tree order; and the schedule
    counts (objects with count alone)."""
    adams, counts = [], []

    def has(t, name):
        if hasattr(t, "_fields"):          # a NamedTuple (optax's states)
            return name in t._fields
        if isinstance(t, (dict, list, tuple, np.ndarray)):
            return False
        return hasattr(t, name)

    def walk(t):
        if all(has(t, a) for a in ("count", "mu", "nu")):
            adams.append(t)
        elif has(t, "count"):
            counts.append(t.count)
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, (list, tuple)):
            for v in t:
                walk(v)
        elif hasattr(t, "_asdict"):
            for v in t._asdict().values():
                walk(v)
        elif hasattr(t, "__dict__"):
            for v in vars(t).values():
                walk(v)

    walk(tree)
    return adams, counts


def opt_state_from_jax(jax_state, model: nn.Module, opt, sched=None):
    """Carry the JAX package's optax Adam state (train.trainer
    .make_optimizer's; numpy or array leaves) into the torch Adam `opt`
    over `model`: mu -> exp_avg, nu -> exp_avg_sq, count -> step, leaves
    named by the flattening params_from_jax uses. A multi_transform
    state's masked leaves are skipped. With `sched` (a StepLR), the
    schedule's count becomes its last_epoch and the groups' learning
    rates its closed form. Returns opt."""
    adams, counts = _adam_states(jax_state)
    if not adams:
        raise ValueError("no Adam state (count, mu, nu) in the JAX state")
    params = dict(model.named_parameters())
    for adam in adams:
        mu, nu = _flatten(adam.mu), _flatten(adam.nu)
        step = float(np.asarray(adam.count))
        for name, m in mu.items():
            if name not in params:
                raise ValueError(f"{name}: no such parameter")
            p = params[name]
            if not p.requires_grad:
                continue
            as_t = lambda a: torch.from_numpy(np.array(a, np.float32)).to(
                p.device)
            opt.state[p] = {"step": torch.tensor(step),
                            "exp_avg": as_t(m), "exp_avg_sq": as_t(nu[name])}
    if sched is not None and counts:
        count = int(np.asarray(counts[0]))
        sched.last_epoch = count
        for g, base in zip(opt.param_groups, sched.base_lrs):
            g["lr"] = base * sched.gamma ** (count // sched.step_size)
        sched._last_lr = [g["lr"] for g in opt.param_groups]
    return opt
