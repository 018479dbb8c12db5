"""Readers of pickled graph samples written by other code, such as the
reference implementation's dill pickles of its heterograph and trajectory
objects, and `--gr_grid` tables.

Loading those pickles would need the writer's modules. The permissive
unpickler here builds every class it does not have as a generic
attribute bag (`ShimObject`), so the arrays load with none of that code.
A sample pickle holds a list of heterograph objects whose
`feature_dicts` / `edge_index_dicts` / `edge_weight_dicts` / `mask` /
`target_dicts` numpy dicts have the layout of data.heterograph.
"""

from __future__ import annotations

import gzip
import io
import pickle
from typing import Any, Dict, List, Optional

import numpy as np

from ..graph import schema, state


class ShimObject:
    """Stand-in for a class the unpickler does not have: stores the
    pickled state and answers attribute access. repr names the original
    class."""

    _shim_class = "?"

    def __init__(self, *args, **kwargs):
        pass

    def __setstate__(self, st):
        if isinstance(st, dict):
            self.__dict__.update(st)
        else:
            self.__dict__["_state"] = st

    def __repr__(self):
        return f"<ShimObject {self._shim_class} with {sorted(self.__dict__)[:8]}>"


_ALLOWED_MODULE_PREFIXES = (
    "numpy",
    "collections",
    "builtins",
    "copyreg",
    "__builtin__",
    "dill",   # dill's own reducers must resolve to the real functions
    "_dill",
    "scipy",
)


class _PermissiveUnpickler(pickle.Unpickler):
    """An Unpickler that builds a ShimObject subclass for any class of a
    module outside _ALLOWED_MODULE_PREFIXES, and resolves numpy, dill and
    scipy names normally."""

    def find_class(self, module: str, name: str):
        if name == "__dict__":
            # dill pickles a __main__ function by value with a reference to
            # __main__.__dict__ as its globals: give it an empty namespace
            # (such functions are never called, only arrays are read)
            return {}
        if module.startswith(_ALLOWED_MODULE_PREFIXES):
            return super().find_class(module, name)
        if module.startswith("torch"):
            raise pickle.UnpicklingError(f"refusing torch payload {module}.{name}")
        return type(name, (ShimObject,), {"_shim_class": f"{module}.{name}"})


def load_pickle(path: str) -> Any:
    """The object of a pickle (gzipped where path ends in .gz), unknown
    classes as ShimObjects."""
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rb") as f:
        data = f.read()
    return _PermissiveUnpickler(io.BytesIO(data)).load()


def heterograph_to_arrays(hg: Any) -> Dict[str, Any]:
    """The array dicts of one (shim-loaded) heterograph: features, edge
    index and weight by edge type, masks, edge types, physical parameters
    and targets (with the edge mask as targets["edge_mask"])."""
    edge_types = [tuple(et) for et in getattr(hg, "edge_type", schema.EDGE_TYPES)]
    out = {
        "features": {k: np.asarray(v) for k, v in hg.feature_dicts.items()},
        "edge_index": {
            tuple(k): np.asarray(v) for k, v in hg.edge_index_dicts.items()
        },
        "edge_weight": {
            tuple(k): np.asarray(v) for k, v in hg.edge_weight_dicts.items()
        },
        "mask": {k: np.asarray(v) for k, v in hg.mask.items()},
        "edge_types": edge_types,
        "physical_params": dict(getattr(hg, "physical_params", {})),
    }
    targets = {}
    for k, v in getattr(hg, "target_dicts", {}).items():
        targets[k] = np.asarray(v)
    if "edge" in getattr(hg, "mask", {}):
        targets["edge_mask"] = np.asarray(hg.mask["edge"])
    out["targets"] = targets
    return out


def heterograph_to_sample(
    hg: Any,
    *,
    device="cpu",
    grain_cap: Optional[int] = None,
    joint_cap: Optional[int] = None,
    jj_edge_cap: Optional[int] = None,
    grain_ring: int = schema.DEFAULT_GRAIN_RING,
) -> state.GraphSample:
    """The padded GraphSample of one heterograph on `device`."""
    a = heterograph_to_arrays(hg)
    return state.build_sample(
        a["features"],
        a["edge_index"],
        a["edge_weight"],
        a["mask"],
        a["targets"] or None,
        device=device,
        grain_cap=grain_cap,
        joint_cap=joint_cap,
        jj_edge_cap=jj_edge_cap,
        grain_ring=grain_ring,
    )


def load_sample_list(path: str) -> List[Any]:
    """The pickle at path as a list (one object becomes a list of one)."""
    obj = load_pickle(path)
    if not isinstance(obj, list):
        obj = [obj]
    return obj
