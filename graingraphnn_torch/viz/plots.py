"""Matplotlib reporting plots (reference train.py:404-441, plots/,
graph_trajectory.py:244-280,847-887). All functions take data + path and
save a .png; headless backend. A copy of the JAX package's module (it
imports no JAX), so that the port stands alone; matplotlib is imported
with it, so nothing on the card's path imports it."""

from __future__ import annotations

from typing import Dict, List, Sequence

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np


def loss_curves(train_loss, valid_loss, path, title=""):
    fig, ax = plt.subplots()
    ax.semilogy(train_loss)
    ax.semilogy(valid_loss)
    ax.set_xlabel("epoch")
    ax.set_ylabel("loss")
    ax.legend(["training loss", "validation loss"])
    if title:
        plt.title(title)
    fig.savefig(path, dpi=300, bbox_inches="tight")
    plt.close(fig)
    return path


def pr_curve(plist, rlist, path):
    fig, ax = plt.subplots()
    ax.scatter(rlist, plist)
    ax.set_ylim(bottom=0.0)
    ax.set_xlim(left=0.0)
    ax.set_xlabel("Recall")
    ax.set_ylabel("Precision")
    plt.title("Precision-Recall Plot")
    fig.savefig(path, dpi=300, bbox_inches="tight")
    plt.close(fig)
    return path


def size_distribution(pred_sizes, path, truth_sizes=None, step=2):
    """Grain-size distributions (graph_trajectory.qoi, :244-280)."""
    bins = np.arange(0, 20, step)
    fig, ax = plt.subplots(figsize=(5, 5))
    dis, edges = np.histogram(pred_sizes, bins, density=True)
    centers = 0.5 * (edges[:-1] + edges[1:])
    ax.plot(centers, dis * np.diff(edges)[0], "r--", label="GNN")
    if truth_sizes is not None:
        dis_t, _ = np.histogram(truth_sizes, bins, density=True)
        ax.plot(centers, dis_t * np.diff(edges)[0], "b", label="PF")
    ax.set_xlim(0, 20)
    ax.set_xlabel(r"$d\ (\mu m)$")
    ax.set_ylabel(r"$P$")
    ax.legend()
    fig.savefig(path, dpi=300, bbox_inches="tight")
    plt.close(fig)
    return path


def event_accuracy(grain_acc_list, path):
    """PF vs GNN grain-elimination counts over height
    (graph_trajectory.event_acc, :847-857)."""
    z = [i[0] for i in grain_acc_list]
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.plot(z, [i[1] for i in grain_acc_list], "b")
    ax.plot(z, [i[2] for i in grain_acc_list], "r")
    ax.plot(z, [i[3] for i in grain_acc_list], "r--")
    ax.set_xlabel(r"$z_l\ (\mu m)$")
    ax.set_ylabel("# grain eliminations")
    ax.legend(["PF", "GNN", "GNN TP"])
    fig.savefig(path, dpi=300, bbox_inches="tight")
    plt.close(fig)
    return path


def layer_error(layer_err_list, path):
    """Misclassification rate over height (graph_trajectory.layer_err)."""
    z = [i[0] for i in layer_err_list]
    fig, ax = plt.subplots(figsize=(5, 5))
    ax.plot(z, [i[1] for i in layer_err_list], "b")
    ax.set_xlabel(r"$z_l\ (\mu m)$")
    ax.set_ylabel("MR")
    fig.savefig(path, dpi=300, bbox_inches="tight")
    plt.close(fig)
    return path


def misorientation(z, curves: Dict[str, Sequence[float]], path):
    """Volume-weighted misorientation vs height
    (graph_trajectory.misorientation, :870-887)."""
    fig, ax = plt.subplots(figsize=(5, 5))
    styles = {"PF": "b", "GNN": "r--"}
    for label, curve in curves.items():
        ax.plot(z, curve, styles.get(label, "k"), label=label)
    ax.set_xlabel(r"$z_l\ (\mu m)$")
    ax.set_ylabel(r"$\Delta \theta (^{\circ})$")
    ax.legend()
    fig.savefig(path, dpi=300, bbox_inches="tight")
    plt.close(fig)
    return path


def snapshot_grid(
    fields: Sequence[np.ndarray],
    path: str,
    titles: Sequence[str] | None = None,
    cmap: str = "coolwarm_r",
):
    """Grid of PF cross-section snapshots (plots/snapshots.py:23-62):
    near-square row x col layout, imshow(u.T) per panel, no ticks, optional
    per-panel titles. `fields` are [nx, ny] id/angle fields (e.g. h5
    `cross_sec` planes or rollout alpha_field_list entries)."""
    n = len(fields)
    row = max(int(np.sqrt(n)), 1)
    col = (n + row - 1) // row
    fig, ax = plt.subplots(row, col, figsize=(10, 10), squeeze=False)
    for k in range(row * col):
        a = ax[k // col][k % col]
        a.set_xticks([])
        a.set_yticks([])
        if k >= n:
            a.axis("off")
            continue
        a.imshow(np.asarray(fields[k]).T, cmap=plt.get_cmap(cmap))
        if titles is not None:
            a.set_title(str(titles[k]), fontsize=6)
    fig.savefig(path, dpi=300, bbox_inches="tight")
    plt.close(fig)
    return path


def snapshot_grid_from_h5(
    h5_path: str,
    path: str,
    frames: Sequence[int],
    var: str = "cross_sec",
):
    """Time-mode snapshot grid straight from a PF h5 (plots/snapshots.py
    __main__, mode='time'): one panel per requested frame of `var`."""
    import h5py

    with h5py.File(h5_path, "r") as f:
        fnx = len(np.asarray(f["x_coordinates"]))
        fny = len(np.asarray(f["y_coordinates"]))
        length = fnx * fny
        data = np.asarray(f[var])
        fields = [
            data[t * length:(t + 1) * length].reshape((fnx, fny), order="F")[
                1:-1, 1:-1
            ]
            for t in frames
        ]
    return snapshot_grid(fields, path, titles=[f"t={t}" for t in frames])


def aggregate_event_stats(filenames: List[str]):
    """Aggregate (pred, truth) event counts encoded in result filenames
    (reference param_stat.py:12-23, pattern 'elimp<P>_t<T>')."""
    import re

    tp = t = 0
    for name in filenames:
        m = re.search(r"elimp(\d+)_t(\d+)", name)
        if m:
            tp += int(m.group(1))
            t += int(m.group(2))
    return tp, t
