"""Training CLI of the port:

  python -m graingraphnn_torch.cli.train --model_type=regressor --model_id=0 \
      --dataset=path/to/train.pkl [--platform=cpu]

The dataset is the pickle `cli.extract --mode=train` writes: a list of
{"feature_dicts", "edge_index_dicts", "edge_weight_dicts", "mask",
"target_dicts", ...}. Runs on the card unless --platform=cpu. The
hyperparameters come from the model_id grid, as in the JAX package's CLI,
or with --config from a checkpoint's .json (e.g.
artifacts/40um/regressor0.json). Writes <model_dir>/<prefix><model_type>
<model_id>.{ckpt,json}, which both packages load.
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import torch


def load_datasets(path: str, device, use_sample="all", train_ratio=0.95):
    """(train, valid) GraphDatasets of the pickle at `path` on `device`:
    every sample padded to the corpus's common capacities, the first
    `use_sample` only unless "all", split in order."""
    from ..data.dataset import GraphDataset, common_capacities, split
    from ..graph import schema, state
    from ..train import checkpoint

    raw = checkpoint.load_pickle(path)
    if use_sample != "all":
        raw = raw[: int(use_sample)]
    sizes = [
        (
            r["feature_dicts"]["grain"].shape[0],
            r["feature_dicts"]["joint"].shape[0],
            int((r["edge_index_dicts"][schema.EDGE_TYPES[2]][0] > -1).sum()),
        )
        for r in raw
    ]
    ng, nj, ne = common_capacities(sizes)
    samples = []
    for r in raw:
        targets = dict(r["target_dicts"])
        if "edge" in r["mask"]:
            targets["edge_mask"] = r["mask"]["edge"]
        samples.append(
            state.build_sample(
                r["feature_dicts"], r["edge_index_dicts"], r["edge_weight_dicts"],
                {"grain": r["mask"]["grain"], "joint": r["mask"]["joint"]},
                targets, device=device, grain_cap=ng, joint_cap=nj,
                jj_edge_cap=ne,
            )
        )
    train_list, valid_list = split(samples, train_ratio)
    return GraphDataset(train_list), GraphDataset(valid_list)


def main(argv=None):
    p = argparse.ArgumentParser("Train the model (PyTorch/CUDA port).")
    p.add_argument("--dataset", type=str, required=True,
                   help="pickle of extracted training samples (cli.extract --mode=train)")
    p.add_argument("--platform", type=str, default="gpu", choices=["gpu", "cpu"])
    p.add_argument("--use_sample", type=str, default="all")
    p.add_argument("--model_dir", type=str, default="./model/")
    p.add_argument("--model_id", type=int, default=0)
    p.add_argument("--prefix", type=str, default="")
    p.add_argument("--model_type", type=str, default="regressor")
    p.add_argument("--regressor_id", type=int, default=0)
    p.add_argument("--seed", type=int, default=35)
    p.add_argument("--train_ratio", type=float, default=0.95)
    p.add_argument("--epochs", type=int, default=0, help="override hp.epoch")
    p.add_argument("--history", action="store_true")
    p.add_argument("--edge_len", action="store_true")
    p.add_argument("--no-transfer", dest="transfer", action="store_false")
    p.add_argument("--config", type=str, default="",
                   help="a checkpoint's .json (e.g. artifacts/40um/"
                        "regressor0.json): its HyperParams, model_type and "
                        "model_id replace the flags' and the model_id grid's")
    p.set_defaults(transfer=True)
    args = p.parse_args(argv)

    from ..models import grain_nn, hyper
    from ..train import checkpoint, trainer

    device = torch.device("cuda" if args.platform == "gpu" else "cpu")
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--platform=gpu: no CUDA device; pass "
                               "--platform=cpu to train on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    train_ds, valid_ds = load_datasets(args.dataset, device, args.use_sample,
                                       args.train_ratio)
    print(f"number of train, validation runs {len(train_ds)} {len(valid_ds)}")

    if args.config:
        hp = checkpoint.load_hp(args.config.removesuffix(".json"))
        hp = dataclasses.replace(hp, history=hp.history or args.history,
                                 edge_len=hp.edge_len or args.edge_len)
    elif args.model_type == "regressor":
        hp = hyper.regressor(args.model_id, history=args.history,
                             edge_len=args.edge_len)
    elif args.transfer:
        hp = hyper.classifier_transfered(args.model_id)
    else:
        hp = hyper.classifier(args.model_id)

    gen = torch.Generator().manual_seed(args.seed)
    if hp.model_type == "regressor":
        model = grain_nn.init_regressor(hp, gen)
    elif hp.transfer:
        reg, _, _ = checkpoint.load_model(
            os.path.join(args.model_dir, f"regressor{args.regressor_id}"), "cpu")
        model = grain_nn.init_classifier(hp, gen, regressor=reg)
        print("transfered learned parameters from regressor")
    else:
        model = grain_nn.init_classifier(hp, gen)
    model = model.to(device)

    epochs = args.epochs or hp.epoch
    model, hist = trainer.train(hp, model, train_ds, valid_ds, epochs=epochs,
                                seed=args.seed)
    extra = {}
    if "threshold" in hist:
        extra["threshold"] = hist["threshold"]
    checkpoint.save(
        os.path.join(args.model_dir, f"{args.prefix}{hp.model_type}{hp.model_id}"),
        model, hp, extra=extra,
    )
    print("training time", hist["time"])


if __name__ == "__main__":
    main()
