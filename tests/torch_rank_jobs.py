"""Work that the port's partitioned tests run on the ranks of
parallel.mesh.launch. Each rank imports this module, so it imports only
the port (and numpy, torch): no JAX. `run_jobs(mesh, jobs)` runs a list of
(name, args) in order on every rank and returns their results; a job
returns numpy, or None on the ranks past 0 where only rank 0's result is
read."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from graingraphnn_torch.parallel import halo
from graingraphnn_torch.parallel import partitioned_rollout as pro
from graingraphnn_torch.parallel import sharded_editor as se
from graingraphnn_torch.rollout import device_rollout as dr


def _np(t):
    return None if t is None else t.cpu().numpy()


def halo_forward(mesh, model, arrays, D):
    """The striped forward of `model` on the graph `arrays` (build_striped's
    arguments): its outputs scattered back to the original order."""
    striped, meta = halo.build_striped(*arrays, D)
    y = halo.make_halo_forward(model, mesh)(striped)
    out = {}
    for k, v in y.items():
        if k in ("joint", "grain", "grain_area"):
            kind = "joint" if k == "joint" else "grain"
            out[k] = _np(meta.scatter_back(v, kind))
        else:
            out[k] = _np(meta.scatter_back_jj(v))
    return out


def exchange_bytes(mesh):
    """Bytes this rank sent by exchange() so far, and the exchanges."""
    return mesh.bytes_exchanged, mesh.exchanges


COLLECTIVE_X = np.arange(12, dtype=np.float32).reshape(3, 4)


def expected_collectives(D):
    """What collectives(mesh, COLLECTIVE_X) returns on each rank of D."""
    x = COLLECTIVE_X
    return [{"left": x + (r - 1) % D, "right": x + (r + 1) % D,
             "sum": D * x + D * (D - 1) // 2, "max": x + D - 1,
             "any": x + D - 1 > x.max(),
             "gather": np.stack([x + k for k in range(D)])}
            for r in range(D)]


def collectives(mesh, x):
    """The mesh's three collectives on x + rank (x numpy, moved to this
    rank's device): the exchange, all_reduce (sum, max, and max of a bool
    tensor) and all_gather; with the backend and the bytes exchanged."""
    t = torch.from_numpy(x).to(mesh.device) + mesh.rank
    left, right = mesh.exchange(t)
    return {"backend": mesh.backend, "device": mesh.device.type,
            "left": _np(left), "right": _np(right),
            "sum": _np(mesh.all_reduce(t)),
            "max": _np(mesh.all_reduce(t, "max")),
            "any": _np(mesh.all_reduce(t > x.max(), "max")),
            "gather": _np(mesh.all_gather(t)),
            "bytes": mesh.bytes_exchanged}


_GROWN = {}   # the last partitioned_run's final working set


def sharded_edit(mesh, inputs, wq, wp, rounds):
    """One sharded edit of the full padded arrays `inputs` (numpy: E_pp,
    E_pq, logits, xj, y_joint, mask_g, mask_j, n_pp, ge, y_grain,
    threshold); each rank takes its column block. wq == "grown" takes the
    working set the last partitioned_run grew to. Returns the edited
    arrays, the blocks gathered, and the flags."""
    if wq == "grown":
        wq, wp, rounds = _GROWN["widths"]
    t = {k: torch.from_numpy(np.asarray(v)) for k, v in inputs.items()
         if k != "threshold"}
    D, r = mesh.D, mesh.rank
    bp, bq = t["E_pp"].shape[1] // D, t["E_pq"].shape[1] // D
    f = se.make_sharded_editor(mesh, wq=wq, wp=wp, rounds=rounds)
    (pp, pq, xj, mg, mj, n_pp, sw, ex, invalid) = f(
        t["E_pp"][:, r * bp: (r + 1) * bp].contiguous(),
        t["E_pq"][:, r * bq: (r + 1) * bq].contiguous(),
        t["logits"][r * bp: (r + 1) * bp].contiguous(), t["xj"],
        t["y_joint"], t["mask_g"], t["mask_j"], t["n_pp"], t["ge"],
        t["y_grain"], inputs["threshold"])
    E_pp = mesh.all_gather(pp).permute(1, 0, 2).reshape(2, -1)
    E_pq = mesh.all_gather(pq).permute(1, 0, 2).reshape(2, -1)
    return {"E_pp": _np(E_pp), "E_pq": _np(E_pq), "xj": _np(xj),
            "mask_g": _np(mg), "mask_j": _np(mj), "n_pp": _np(n_pp),
            "switching": _np(sw), "extra": _np(ex),
            "invalid": bool(invalid)}


STATE_FIELDS = [f.name for f in dataclasses.fields(dr.DeviceRolloutState)]


def partitioned_run(mesh, reg, cls, state, n_spans, kw):
    """PartitionedRollout.run from the numpy state dict `state`. Returns
    (state dict, aux, final working-set width)."""
    st = dr.DeviceRolloutState(**{
        k: None if state.get(k) is None else torch.from_numpy(state[k])
        for k in STATE_FIELDS})
    roll = pro.PartitionedRollout(reg, cls, mesh, **kw)
    floor = roll._wp
    st, aux = roll.run(st, n_spans)
    _GROWN["widths"] = (roll._wq, roll._wp, roll.rounds)
    return ({k: _np(getattr(st, k)) for k in STATE_FIELDS}, aux,
            (floor, roll._wp))


def engine_halo(mesh, reg, cls, recipe, kw):
    """RolloutEngine(halo=(mesh, D)).run's result on the generate-mode
    graph of recipe = (lxd, seed, G, R)."""
    from graingraphnn_torch.data import extraction
    from graingraphnn_torch.rollout.engine import RolloutEngine

    traj = extraction.generate(*recipe)
    hg0 = extraction.make_test_sample(traj, span=6)
    kw = dict(kw)
    eng = RolloutEngine(reg, cls, halo=(mesh, mesh.D),
                        c_threshold=kw.pop("c_threshold"),
                        seed=kw.pop("seed"))
    return eng.run(hg0, traj, **kw)


JOBS = {f.__name__: f for f in (halo_forward, exchange_bytes, collectives,
                                sharded_edit, partitioned_run, engine_halo)}


def run_jobs(mesh, jobs):
    """Run (name, args) jobs in order on this rank; returns their
    results."""
    torch.manual_seed(0)
    return [JOBS[name](mesh, *args) for name, args in jobs]

