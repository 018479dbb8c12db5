"""Distributed training CLI of the port (the JAX package's cli.dist_train):

  python -m graingraphnn_torch.cli.dist_train --dataset=train.pkl \
      --n_devices=4 [--partition dp|hybrid|halo] [--gp G] [--platform cpu]

--n_devices D runs the job on D ranks of parallel.mesh.launch (NCCL with
a card per rank; gloo on the CPU and for ranks that share one card, every
collective staged through host buffers there); --multihost makes this
process one rank of a group set up from the environment (torch.distributed
env://: MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE, LOCAL_RANK), the
counterpart of jax.distributed.initialize(). Runs on the card unless
--platform=cpu.

  dp      the global batch (batch_size x D) split over the ranks
          (parallel.data_parallel), the gradients averaged;
  hybrid  dp x gp ranks: the batch over dp, each sample's node rows over
          gp (parallel.partition; gp = --gp or half the ranks), capacities
          rounded up to a multiple of gp;
  halo    one graph a step in periodic x-stripes (parallel.halo), one a
          rank; --gp lowers the stripe count (and the ranks) where
          stripes would be narrower than the interaction range; stripes
          at the dataset's common capacities.

The JAX CLI's arithmetic is kept: steps_per_epoch = len // global_batch
with drop_last and the shuffle seed + epoch (an epoch of fewer samples
than one global batch takes no step), the halo mode's graphs in order.
The hyperparameters come from the model_id grid, or with --config from a
checkpoint's .json. Writes <model_dir>/dist_<model_type><model_id>.{ckpt,
json} with the optimizer's and the schedule's state (checkpoint.load_model
reads it, and cli.test runs it under the name regressor<id> /
classifier<id>); --resume <that path> continues the run from its epoch.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import torch


def parse(argv=None):
    p = argparse.ArgumentParser("Distributed training (PyTorch/CUDA port)")
    p.add_argument("--dataset", type=str, required=True)
    p.add_argument("--platform", type=str, default="gpu",
                   choices=["gpu", "cpu"])
    p.add_argument("--n_devices", type=int, default=0,
                   help="ranks; 0 = every card (one rank on the CPU)")
    p.add_argument("--model_type", type=str, default="regressor")
    p.add_argument("--model_id", type=int, default=0)
    p.add_argument("--model_dir", type=str, default="./model/")
    p.add_argument("--epochs", type=int, default=0)
    p.add_argument("--seed", type=int, default=35)
    p.add_argument("--multihost", action="store_true",
                   help="this process is one rank of a group set up from "
                        "the environment (torch.distributed env://)")
    p.add_argument("--partition", type=str, default="dp",
                   choices=["dp", "hybrid", "halo"],
                   help="dp: batch sharding; hybrid: dp x gp node-row "
                        "sharding (all-gather); halo: spatial stripes with "
                        "a neighbour exchange, one graph per step")
    p.add_argument("--gp", type=int, default=0,
                   help="graph-partition axis size for --partition=hybrid "
                        "(0 = half the ranks); the stripe count for "
                        "--partition=halo (0 = every rank)")
    p.add_argument("--config", type=str, default="",
                   help="a checkpoint's .json whose HyperParams replace "
                        "the model_id grid's")
    p.add_argument("--resume", type=str, default="",
                   help="a checkpoint this CLI wrote: its weights, "
                        "optimizer and schedule state, and epoch")
    return p.parse_args(argv)


def layout(args, D: int):
    """(ranks, mesh axes) of the run on D devices."""
    if args.partition == "halo":
        n = args.gp or D
        return n, (("gp", n),)
    if args.partition == "hybrid":
        gp = args.gp or max(1, D // 2)
        if D % gp:
            raise ValueError(f"--gp {gp} does not divide {D} ranks")
        return D, (("dp", D // gp), ("gp", gp))
    return D, (("dp", D),)


def main(argv=None, mesh=None):
    """Parse argv and train. Launches the ranks, or with --multihost joins
    the environment's group; with `mesh` (inside a rank of a launch) runs
    this rank's part. Returns rank 0's summary (train losses by epoch, ms
    per step, bytes sent per rank, the checkpoint's path)."""
    args = parse(argv)
    device = "cuda" if args.platform == "gpu" else "cpu"
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--platform=gpu: no CUDA device; pass "
                           "--platform=cpu to train on the CPU")
    from ..parallel import mesh as mesh_mod

    if mesh is not None:
        return run(mesh, args)
    if args.multihost:
        world = int(os.environ["WORLD_SIZE"])
        n, axes = layout(args, world)
        if n != world:
            raise ValueError(f"{n} ranks wanted, the group has {world}")
        return run(mesh_mod.init_from_env(device, axes), args)
    D = args.n_devices or (torch.cuda.device_count() if device == "cuda"
                           else 1)
    n, axes = layout(args, D)
    # ranks on the CPU share its cores: more threads than cores in all
    # slow every rank's barriers by orders of magnitude
    threads = max(1, (os.cpu_count() or 1) // n) if device == "cpu" else 0
    return mesh_mod.launch(run, n, args, device=device, axes=axes,
                           threads=threads)[0]


def _samples(raw, device, caps):
    from ..graph import state

    return [state.build_sample(
        r["feature_dicts"], r["edge_index_dicts"], r["edge_weight_dicts"],
        {"grain": r["mask"]["grain"], "joint": r["mask"]["joint"]},
        dict(r["target_dicts"]), device=device, grain_cap=caps[0],
        joint_cap=caps[1], jj_edge_cap=caps[2]) for r in raw]


def _striped(raw, D):
    """Every graph's stripes at the dataset's common capacities."""
    from ..parallel import halo

    def build(r, caps):
        return halo.build_striped(
            r["feature_dicts"], r["edge_index_dicts"],
            r["edge_weight_dicts"],
            {"grain": r["mask"]["grain"], "joint": r["mask"]["joint"]},
            D, dict(r["target_dicts"]), **caps)

    built = [build(r, {}) for r in raw]
    caps = {"grain_cap": max(m.grain_cap for _, m in built),
            "joint_cap": max(m.joint_cap for _, m in built),
            "jj_cap": max(m.jj_cap for _, m in built)}
    key = tuple(caps.values())
    return [s if (m.grain_cap, m.joint_cap, m.jj_cap) == key
            else build(r, caps)[0] for (s, m), r in zip(built, raw)]


def run(mesh, args):
    """One rank's part of the run on `mesh`."""
    from ..data.dataset import GraphDataset, common_capacities, split
    from ..graph import schema
    from ..models import grain_nn, hyper
    from ..parallel import data_parallel, halo, partition
    from ..train import checkpoint, trainer

    dev = mesh.device
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    say = print if mesh.rank == 0 else (lambda *a, **k: None)
    raw = checkpoint.load_pickle(args.dataset)

    if args.config:
        hp = checkpoint.load_hp(args.config.removesuffix(".json"))
    elif args.model_type == "regressor":
        hp = hyper.regressor(args.model_id)
    else:
        hp = hyper.classifier(args.model_id)
    gen = torch.Generator().manual_seed(args.seed)
    saved, start = None, 1
    if args.resume:
        tree, hp, _extra, saved = checkpoint.load(args.resume,
                                                  opt_state=True)
        if saved is None:
            raise ValueError(f"{args.resume}: no optimizer state to resume")
        model = checkpoint.params_from_jax(tree, hp, dev)
        start = int(saved["epoch"]) + 1
    elif hp.model_type == "regressor":
        model = grain_nn.init_regressor(hp, gen).to(dev)
    else:
        model = grain_nn.init_classifier(hp, gen).to(dev)
    epochs = args.epochs or hp.epoch

    if args.partition == "halo":
        train_list, _valid = split([s.to(dev) for s in
                                    _striped(raw, mesh.size("gp"))])
        say(f"halo stripes over {mesh.size('gp')} ranks, "
            f"{len(train_list)} graphs")
        steps_per_epoch = max(1, len(train_list))
        opt, sched = trainer.make_optimizer(hp, model, steps_per_epoch)
        step = halo.make_halo_train_step(hp, model, opt, sched, mesh, "gp")

        def batches(epoch):
            return train_list
    else:
        gp = mesh.size("gp") if args.partition == "hybrid" else 1
        dp = mesh.size("dp")
        sizes = [(r["feature_dicts"]["grain"].shape[0],
                  r["feature_dicts"]["joint"].shape[0],
                  int((r["edge_index_dicts"][schema.EDGE_TYPES[2]][0]
                       > -1).sum())) for r in raw]
        # node and edge capacities must split over gp
        caps = [-(-v // gp) * gp for v in common_capacities(sizes)]
        train_list, _valid = split(_samples(raw, dev, caps))
        train_ds = GraphDataset(train_list)
        # the global batch is the per-rank batch times dp
        global_batch = hp.batch_size * dp
        steps_per_epoch = max(1, len(train_ds) // global_batch)
        opt, sched = trainer.make_optimizer(hp, model, steps_per_epoch)
        if args.partition == "hybrid":
            say(f"hybrid dp={dp} x gp={gp} over {mesh.D} ranks")
            step = partition.make_hybrid_train_step(hp, model, opt, sched,
                                                    mesh)
        else:
            say(f"data-parallel over {mesh.D} ranks")
            step = data_parallel.make_dp_train_step(hp, model, opt, sched,
                                                    mesh, "dp")

        def batches(epoch):
            return train_ds.batches(global_batch, shuffle=True,
                                    seed=args.seed + epoch, drop_last=True)
    if saved is not None:
        checkpoint.restore_opt_state(opt, sched, saved)

    history, step_ms = [], []
    t0 = time.time()
    for epoch in range(start, epochs + 1):
        tot, count = 0.0, 0
        for batch in batches(epoch):
            t1 = time.perf_counter()
            tot += float(step(batch))        # the loss's read syncs
            step_ms.append((time.perf_counter() - t1) * 1e3)
            count += 1
        history.append(tot / max(count, 1))
        say(f"Epoch:{epoch}, Train loss:{history[-1]:.6f}")
    seconds = time.time() - t0
    say("training time", seconds)
    sent = {"exchange": mesh.bytes_exchanged,
            "all_gather": mesh.bytes_gathered,
            "all_reduce": mesh.bytes_reduced}
    say(f"ms per step {sum(step_ms) / max(len(step_ms), 1):.3f} over "
        f"{len(step_ms)} steps; bytes sent per rank {sent}")
    path = os.path.join(args.model_dir,
                        f"dist_{hp.model_type}{hp.model_id}")
    if mesh.rank == 0:
        checkpoint.save(path, model, hp, opt_state=checkpoint.opt_state_of(
            opt, sched, epoch=epochs))
    mesh.barrier()
    return {"train_loss": history, "epochs": list(range(start, epochs + 1)),
            "step_ms": step_ms, "seconds": seconds, "bytes_sent": sent,
            "checkpoint": path, "ranks": mesh.D, "axes": mesh.axes,
            "hp": dataclasses.asdict(hp)}


if __name__ == "__main__":
    main()
