"""Work that the port's partitioned tests run on the ranks of
parallel.mesh.launch. Each rank imports this module, so it imports only
the port (and numpy, torch): no JAX. `run_jobs(mesh, jobs)` runs a list of
(name, args) in order on every rank and returns their results; a job
returns numpy, or None on the ranks past 0 where only rank 0's result is
read."""

from __future__ import annotations

import copy
import dataclasses

import numpy as np
import torch

from graingraphnn_torch.parallel import data_parallel, halo, partition
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


def partitioned_forward(mesh, model, sample, axis):
    """partition.make_partitioned_forward's outputs (every rank's)."""
    y = partition.make_partitioned_forward(model.to(mesh.device), mesh,
                                           axis)(sample)
    return {k: _np(v) for k, v in y.items()}


def collective_grads(mesh, axis, xs, w_left, w_right, w_gather):
    """The differentiable exchange and all_gather along `axis` on x =
    xs[index]: the outputs, and x's gradient of sum(w_left[i] * left +
    w_right[i] * right + w_gather[i] * gathered) (i this rank's index
    along the axis)."""
    i = mesh.index(axis)
    x = torch.from_numpy(xs[i]).to(mesh.device).requires_grad_(True)
    left, right = mesh.exchange(x, axis)
    g = mesh.all_gather(x, axis)
    t = lambda a: torch.from_numpy(a[i]).to(mesh.device)
    loss = ((t(w_left) * left).sum() + (t(w_right) * right).sum()
            + (t(w_gather) * g).sum())
    loss.backward()
    return {"left": _np(left.detach()), "right": _np(right.detach()),
            "gather": _np(g.detach()), "grad": _np(x.grad)}


def bump(mesh, t):
    """Add one to the tensor `t` in place, then, once every rank has,
    return it: t + 1 where each rank holds a copy of its own."""
    t.add_(1.0)
    mesh.barrier()
    return _np(t)


STEPS = {"partitioned": partition.make_partitioned_train_step,
         "halo": halo.make_halo_train_step,
         "dp": data_parallel.make_dp_train_step}


def train_steps(mesh, kind, model, hp, data, opt, n_steps, axes):
    """n_steps of a distributed train step `kind` (partitioned, halo, dp
    or hybrid) of `model` on `data` (a sample, a striped sample or a
    stacked batch) with opt = (name, lr) (sgd or adam) and a constant
    schedule; axes = the step's axis keyword arguments. Returns the
    losses and the parameters after, by name. The model is copied first:
    the jobs of one rank get the one model they were passed."""
    model = copy.deepcopy(model).to(mesh.device)
    name, lr = opt
    params = [p for p in model.parameters() if p.requires_grad]
    o = (torch.optim.SGD(params, lr=lr) if name == "sgd" else
         torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8))
    sched = torch.optim.lr_scheduler.StepLR(o, step_size=1 << 30)
    make = (partition.make_hybrid_train_step if kind == "hybrid"
            else STEPS[kind])
    step = make(hp, model, o, sched, mesh, **axes)
    losses = [float(step(data)) for _ in range(n_steps)]
    return {"losses": losses,
            "params": {k: _np(v.detach()) for k, v in
                       model.named_parameters()},
            "bytes": (mesh.bytes_exchanged, mesh.bytes_gathered,
                      mesh.bytes_reduced)}


def dist_train_resume(mesh, argv, partitions, workdir):
    """cli.dist_train's rank body on this group, per partition (the mesh
    rebuilt on its layout): one epoch, then a run resumed from that
    checkpoint to the second. Returns {partition: (epoch 1's summary,
    the resumed run's)}."""
    from graingraphnn_torch.cli import dist_train
    from graingraphnn_torch.parallel import mesh as mesh_mod

    out = {}
    for part in partitions:
        base = argv + ["--partition", part, "--n_devices", str(mesh.D)]
        axes = dist_train.layout(dist_train.parse(base), mesh.D)[1]
        m = mesh_mod.make_mesh(mesh.D, mesh.rank, mesh.backend, mesh.device,
                               axes)
        d1 = f"{workdir}/{part}_epoch1"
        first = dist_train.main(base + ["--epochs", "1", "--model_dir", d1],
                                mesh=m)
        resumed = dist_train.main(
            base + ["--epochs", "2", "--model_dir", f"{workdir}/{part}_res",
                    "--resume", first["checkpoint"]],
            mesh=m)
        out[part] = (first, resumed)
    return out


JOBS = {f.__name__: f for f in (halo_forward, exchange_bytes, collectives,
                                sharded_edit, partitioned_run, engine_halo,
                                partitioned_forward, collective_grads,
                                train_steps, dist_train_resume, bump)}


def run_jobs(mesh, jobs):
    """Run (name, args) jobs in order on this rank; returns their
    results."""
    torch.manual_seed(0)
    return [JOBS[name](mesh, *args) for name, args in jobs]

