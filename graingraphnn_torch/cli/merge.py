"""Merge per-seed training pickles into one shuffled dataset (shuffle
seed 35 by default):

  python -m graingraphnn_torch.cli.merge --glob 'graphs/*/seed*_train.pkl' \
      --out dataset_train.pkl
"""

from __future__ import annotations

import argparse
import glob
import pickle
import random


def main(argv=None):
    p = argparse.ArgumentParser("Merge seed datasets")
    p.add_argument("--glob", type=str, required=True)
    p.add_argument("--out", type=str, default="dataset_train.pkl")
    p.add_argument("--seed", type=int, default=35)
    args = p.parse_args(argv)

    merged = []
    files = sorted(glob.glob(args.glob))
    for path in files:
        with open(path, "rb") as f:
            merged.extend(pickle.load(f))
    random.Random(args.seed).shuffle(merged)
    with open(args.out, "wb") as f:
        pickle.dump(merged, f)
    print(f"merged {len(files)} files -> {len(merged)} samples -> {args.out}")


if __name__ == "__main__":
    main()
