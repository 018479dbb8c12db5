"""Graph-trajectory CLI of the port: phase-field (PF) simulations to
graph samples, or a generated starting graph.

  python -m graingraphnn_torch.cli.extract --mode=train \
      --rawdat_dir=rawdat_PF/40_40 --seed=10020 --save_dir=graphs/40_40

Modes:
  train    extract the PF .h5 (.h5.gz), calibrate the span, write the
           windowed training samples (the pickle cli.train reads)
  test     extract the PF file's first frame, write the t=0 inference
           sample (its span from --span, else from the --gr_grid table)
  generate the seeded starting graph of --G/--R (no PF data) as a t=0
           sample; --user_config takes the user-facing no-flux config
  check    extract one trajectory and print its frame and quarantine counts

Host-side only (numpy and h5py); the pickles hold numpy arrays and both
packages read them.
"""

from __future__ import annotations

import argparse
import os
import pickle


def dump_states(states, path):
    """The samples' array dicts, span and physical parameters as a pickle
    of a list of dicts."""
    payload = [
        {
            "feature_dicts": s.feature_dicts,
            "target_dicts": s.target_dicts,
            "edge_index_dicts": s.edge_index_dicts,
            "edge_weight_dicts": s.edge_weight_dicts,
            "mask": s.mask,
            "physical_params": s.physical_params,
            "span": s.span,
        }
        for s in states
    ]
    with open(path, "wb") as f:
        pickle.dump(payload, f)
    print("wrote", path)


def main(argv=None):
    p = argparse.ArgumentParser("Generate heterograph trajectory")
    p.add_argument("--mode", type=str, default="test",
                   choices=["train", "test", "generate", "check"])
    p.add_argument("--rawdat_dir", type=str, default="./rawdat_PF/40_40/")
    p.add_argument("--save_dir", type=str, default="./graphs/40_40/")
    p.add_argument("--cache_dir", type=str, default="./data_cache")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--G", type=float, default=2)
    p.add_argument("--R", type=float, default=0.4)
    p.add_argument("--boundary", type=str, default="periodic")
    p.add_argument("--size", dest="adjust_grain_size", action="store_true")
    p.add_argument("--orien", dest="adjust_grain_orien", action="store_true")
    p.add_argument("--frame", type=int, default=121)
    p.add_argument("--span", type=int, default=0)
    p.add_argument("--lxd", type=int, default=40)
    p.add_argument("--prev", type=int, default=0)
    p.add_argument("--save_traj", type=bool, default=True)
    p.add_argument("--gr_grid", type=str, default="./GR_train_grid.pkl",
                   help="the (G, R) -> span table of test and generate "
                        "modes, read when --span is 0")
    p.add_argument("--user_config", action="store_true",
                   help="generate mode: the user-facing config (noflux)")
    args = p.parse_args(argv)

    import numpy as np

    from ..data import extraction, heterograph, reference_io, thermal

    if args.mode in ("train", "check", "test") and not extraction.find_pf_file(
            args.rawdat_dir, args.seed):
        p.error(f"no PF file *seed{args.seed}_*.h5[.gz] in {args.rawdat_dir}")
    os.makedirs(args.save_dir, exist_ok=True)

    def span_of(G, R):
        if args.span:
            return args.span
        return thermal.span_from_gr_grid(
            reference_io.load_pickle(args.gr_grid), G, R)

    if args.mode in ("train", "check"):
        traj = extraction.TrajectoryExtractor(
            lxd=args.lxd, seed=args.seed, frames=args.frame, bc=args.boundary,
            adjust_grain_size=args.adjust_grain_size,
            adjust_grain_orien=args.adjust_grain_orien,
        )
        traj.extract(args.rawdat_dir, cache_dir=args.cache_dir)
        if args.mode == "check":
            print("extracted", len(traj.states), "frames;",
                  "quarantined", traj.save_frame.count(False))
            return
        span = args.span or extraction.calibrate_span(traj)
        print("calibrated span:", span)
        samples = extraction.make_training_samples(traj, span=span,
                                                   prev=args.prev)
        g = str(int(10 * traj.physical_params["G"]))
        r = str(int(10 * traj.physical_params["R"]))
        dump_states(samples, os.path.join(
            args.save_dir, f"seed{args.seed}_G{g}_R{r}_span{span}_train.pkl"))

    elif args.mode == "test":
        traj = extraction.TrajectoryExtractor(
            lxd=args.lxd, seed=args.seed, frames=args.frame, bc=args.boundary,
            adjust_grain_size=args.adjust_grain_size,
            adjust_grain_orien=args.adjust_grain_orien,
        )
        traj.match_graph = False
        traj.extract(args.rawdat_dir, cache_dir=args.cache_dir)
        span = span_of(traj.physical_params["G"], traj.physical_params["R"])
        hg0 = extraction.make_test_sample(traj, span=span)
        g = str(round(traj.physical_params["G"], 3))
        r = str(round(traj.physical_params["R"], 3))
        dump_states([hg0], os.path.join(
            args.save_dir, f"seed{args.seed}_G{g}_R{r}_span{span}.pkl"))

    elif args.mode == "generate":
        user_cfg = None
        if args.user_config:
            # the user-facing geometry and physics: no-flux boundary, the
            # line melt pool, aspect ratios
            user_cfg = thermal.default_generate_config()
            user_cfg["initial_parameters"]["seed"] = args.seed
            user_cfg["physical_parameters"] = {"G": args.G, "R": args.R}
        traj = extraction.TrajectoryExtractor(
            lxd=args.lxd, seed=args.seed, frames=args.frame,
            physical_params={"G": args.G, "R": args.R},
            adjust_grain_size=args.adjust_grain_size,
            adjust_grain_orien=args.adjust_grain_orien,
            user_defined_config=user_cfg,
        )
        ids, counts = np.unique(traj.alpha_field, return_counts=True)
        traj.area_counts = dict(zip(ids, counts))
        traj.area_traj.append(traj.area_counts)
        traj.states.append(heterograph.tensorize(traj, 0))
        span = span_of(args.G, args.R)
        hg0 = extraction.make_test_sample(traj, span=span)
        dump_states([hg0], os.path.join(
            args.save_dir,
            f"seed{args.seed}_G{round(args.G, 3)}_R{round(args.R, 3)}"
            f"_span{span}.pkl"))


if __name__ == "__main__":
    main()
