"""Rollout inference CLI of the port. Without --generate it rolls the
first frame of a phase-field (PF) simulation (the .h5 of --seed in
--rawdat_dir, read through data.extraction) and compares with the PF
truth (layer error, event hits, size-distribution KS):

  python -m graingraphnn_torch.cli.test --rawdat_dir=rawdat_PF/40_40 \
      --seed=10020 --model_dir=artifacts/40um [--jit_editor] [--plot3D]

With --generate it rolls the seeded Voronoi starting graph of any
(lxd, seed, G, R) (data.extraction.generate), with no truth:

  python -m graingraphnn_torch.cli.test --generate \
      --model_dir=artifacts/40um --seed=3 --G=4 --R=1 \
      --meltpool=cylinder --r0=20 --z0=4 [--jit_editor]

By default the host rollout engine (rollout.engine, the JAX package's
default) runs; with --device_resident the device-resident rollout
(rollout.device_driver), spans advancing on the card in chunks of
--eval_every:

  python -m graingraphnn_torch.cli.test --generate --device_resident \
      --model_dir=artifacts/40um --lxd=120 --seed=5 --G=1.904 --R=0.558 \
      --nucleation_density=2e-4 --meltpool=cylinder --r0=20 --z0=4 \
      --c_threshold=0.99 --eval_every=5

--pallas (with --device_resident) runs its forwards on the bf16 edge
kernels, JAX's pallas=True rollout.

With --partition D it runs the partitioned rollout on D ranks spawned
from this command (parallel.mesh.launch; implies the device-resident
path, static and nucleation-free): halo-striped forwards, the
column-sharded editor and the shared finalize. The ranks talk over NCCL
when each has a card of its own, over gloo on the CPU and when they share
one card:

  python -m graingraphnn_torch.cli.test --generate --partition 4 \
      --model_dir=artifacts/40um --seed=3 --G=4 --R=1 --eval_every=5

Runs on the card unless --platform=cpu. The planar graph is rebuilt and
rasterised inside the timed loop. Prints one JSON line with the JAX
package's CLI keys; --plot3D (host engine) also writes the predicted
volume as seed<seed>graph.vtk in the working directory.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from ..data import extraction
from ..parallel import mesh as mesh_mod
from ..rollout import device_driver as dd
from ..rollout.engine import RolloutEngine
from ..train import checkpoint


def _parser():
    p = argparse.ArgumentParser("Rollout inference (PyTorch/CUDA port)")
    p.add_argument("--platform", default="gpu", choices=["gpu", "cpu"])
    p.add_argument("--model_dir", type=str, default="./model/")
    p.add_argument("--rawdat_dir", type=str, default="./rawdat_PF/40_40",
                   help="phase-field data; generate mode ignores it")
    p.add_argument("--cache_dir", type=str, default="./data_cache",
                   help="phase-field cache; generate mode ignores it")
    p.add_argument("--regressor_id", type=int, default=0)
    p.add_argument("--classifier_id", type=int, default=1)
    p.add_argument("--seed", type=int, default=10020)
    p.add_argument("--lxd", type=int, default=40)
    p.add_argument("--span", type=int, default=0)
    p.add_argument("--growth_height", type=float, default=-1)
    p.add_argument("--nucleation_density", type=float, default=0.0)
    p.add_argument("--generate", action="store_true",
                   help="generate mode: roll the starting graph at --lxd "
                        "with --G/--R thermal conditions, no PF truth")
    p.add_argument("--G", type=float, default=10.0)
    p.add_argument("--R", type=float, default=2.0)
    p.add_argument("--meltpool", choices=["line", "cylinder"], default="line",
                   help="cylinder: the moving melt pool's sliding window")
    p.add_argument("--r0", type=float, default=0.8)
    p.add_argument("--z0", type=float, default=0.4)
    p.add_argument("--melt_pool_angle", type=float,
                   default=0.7853981633974483)
    p.add_argument("--c_threshold", type=float, default=0.0,
                   help="override the checkpoint's edge-event threshold")
    p.add_argument("--no-compare", dest="compare", action="store_false",
                   help="do not compare with the PF truth (generate mode "
                        "never compares: it has none)")
    p.set_defaults(compare=True)
    p.add_argument("--verbose", action="store_true")
    p.add_argument("--device_resident", action="store_true",
                   help="spans advance on the device, QoIs pulled every "
                        "--eval_every spans")
    p.add_argument("--eval_every", type=int, default=1)
    p.add_argument("--fused_editor", choices=["auto", "on", "off"],
                   default="auto",
                   help="--device_resident: the single-launch editor (the "
                        "port's only one): auto and on take it, off is "
                        "refused")
    p.add_argument("--jit_editor", action="store_true",
                   help="host engine: edit on the device (the editor "
                        "kernel and the nucleation pass)")
    p.add_argument("--clamp_gr", type=str, default="",
                   help="host engine: 'Gmin,Gmax,Rmin,Rmax' clamps the "
                        "thermal features to the training hull")
    p.add_argument("--temporal", action="store_true",
                   help="host engine: a random (G, R) schedule by height")
    p.add_argument("--interp_frames", type=int, default=0,
                   help="host engine: rasters blended between spans")
    p.add_argument("--plot3D", dest="plot3d", action="store_true",
                   help="host engine: write the predicted volume as VTK")
    p.add_argument("--partition", type=int, default=0,
                   help="run the partitioned rollout on this many ranks "
                        "(implies --device_resident)")
    p.add_argument("--pallas", action="store_true",
                   help="--device_resident: the forwards on the bf16 "
                        "kernels (JAX's fused bf16 Pallas convs)")
    return p


def _args(argv):
    """(args, clamp) of the command line, checked."""
    p = _parser()
    args = p.parse_args(argv)
    if args.partition < 0:
        p.error("--partition takes a number of ranks")
    if args.partition and (args.nucleation_density > 0
                           or args.meltpool == "cylinder"):
        p.error("--partition covers the nucleation-free static-meltpool "
                "rollout; nucleation and the moving melt pool run on the "
                "single-device rollout")
    if args.pallas and args.partition:
        p.error("--partition uses the striped XLA forward; --pallas "
                "applies to the single-device scan")
    if args.pallas and not args.device_resident:
        p.error("--pallas is an option of --device_resident (the host "
                "engine runs the fp32 kernels)")
    if args.meltpool == "cylinder" and not args.generate:
        p.error("--meltpool=cylinder is a generate-mode option")
    if not args.generate and not extraction.find_pf_file(args.rawdat_dir,
                                                         args.seed):
        p.error(f"no phase-field file *seed{args.seed}_*.h5[.gz] in "
                f"{args.rawdat_dir} (or pass --generate)")
    if args.device_resident or args.partition:
        if args.fused_editor == "off":
            p.error("--fused_editor off: the port's device rollout has one "
                    "editor, the editor kernel (topology_jit.update_jit "
                    "runs it too)")
        for flag, given in (("--jit_editor", args.jit_editor),
                            ("--clamp_gr", args.clamp_gr),
                            ("--temporal", args.temporal),
                            ("--interp_frames", args.interp_frames),
                            ("--plot3D", args.plot3d)):
            if given:
                p.error(f"{flag} is an option of the host engine: run "
                        "without --device_resident or --partition")
    clamp = None
    if args.clamp_gr:
        clamp = tuple(float(v) for v in args.clamp_gr.split(","))
        if len(clamp) != 4:
            p.error("--clamp_gr expects 'Gmin,Gmax,Rmin,Rmax'")
    return args, clamp


def _partition_rank(mesh, argv):
    """One rank of `--partition D`: the rollout on this rank's device.
    Returns the result dict on rank 0, None on the others."""
    args, clamp = _args(argv)
    return _run(args, clamp, mesh.device)[0]


def main(argv=None):
    args, clamp = _args(argv)
    device = torch.device("cuda" if args.platform == "gpu" else "cpu")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--platform=gpu: no CUDA device; pass "
                           "--platform=cpu to run the plain versions")
    if args.partition:
        D = args.partition
        argv = sys.argv[1:] if argv is None else list(argv)
        threads = max(1, (os.cpu_count() or D) // D)
        res = mesh_mod.launch(
            _partition_rank, D, argv, device=device.type,
            threads=threads if device.type == "cpu" else 0)[0]
    else:
        res, traj = _run(args, clamp, device)
    if args.plot3d and res["alpha_field_list"]:
        from ..viz.volume import GrainVisual

        gv = GrainVisual(lxd=args.lxd, seed=args.seed,
                         height=traj.final_height)
        out = gv.graph_recon(
            traj.theta_z, res["alpha_field_list"],
            span=(args.span or 6) // (args.interp_frames + 1), frames=121,
            mesh_size=0.08, ini_height=traj.ini_height,
            final_height=traj.final_height,
            out=f"seed{args.seed}graph.vtk")
        print("wrote", out)
    print(json.dumps({
        "final_layer_error": res["final_layer_error"],
        "mean_layer_error": res["mean_layer_error"],
        "events_tp": res["events_tp"],
        "events_truth": res["events_truth"],
        "events_pred": res["events_pred"],
        "KS": res.get("KS"),
        "inference_time_s": round(res["inference_time"], 2),
    }))


def _run(args, clamp, device):
    """The rollout the arguments ask for, on `device`. Returns (result,
    traj); a partitioned run's ranks past 0 return (None, None)."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    span = args.span or 6
    reg, _, _ = checkpoint.load_model(
        os.path.join(args.model_dir, f"regressor{args.regressor_id}"), device)
    cls, _, extra = checkpoint.load_model(
        os.path.join(args.model_dir, f"classifier{args.classifier_id}"),
        device)
    c_threshold = args.c_threshold or extra.get("threshold", 0.6)
    meltpool = None
    if args.meltpool == "cylinder":
        meltpool = {"r0": args.r0, "z0": args.z0,
                    "melt_pool_angle": args.melt_pool_angle}
    if args.generate:
        traj = extraction.generate(args.lxd, args.seed, args.G, args.R)
        args.compare = False
    else:
        traj = extraction.TrajectoryExtractor(lxd=args.lxd, seed=args.seed,
                                              frames=121)
        traj.match_graph = False
        traj.extract(args.rawdat_dir, cache_dir=args.cache_dir)
    hg0 = extraction.make_test_sample(traj, span=span)
    if args.device_resident or args.partition:
        res = dd.run_device_resident(
            dd.trajectory_from_extractor(traj, hg0), reg, cls, span=span,
            c_threshold=c_threshold, eval_every=args.eval_every,
            compare=args.compare, growth_height=args.growth_height,
            verbose=args.verbose, nucleation_density=args.nucleation_density,
            seed=args.seed, partition=args.partition, meltpool=meltpool,
            pallas=args.pallas, device=device)
        if res is None:
            return None, None
    else:
        engine = RolloutEngine(reg, cls, c_threshold=c_threshold,
                               seed=args.seed, verbose=args.verbose,
                               jit_editor=args.jit_editor, device=device)
        res = engine.run(
            hg0, traj, span=span, compare=args.compare,
            growth_height=args.growth_height,
            nucleation_density=args.nucleation_density,
            temporal=args.temporal, interp_frames=args.interp_frames,
            collect_fields=args.plot3d, clamp_gr=clamp, meltpool=meltpool)
    return res, traj


if __name__ == "__main__":
    main()
