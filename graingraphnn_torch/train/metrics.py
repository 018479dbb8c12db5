"""Evaluation metrics (numpy only; the JAX package's, line for line).

`FeatureMetric` accumulates masked relative feature errors and PR curves;
`class_acc` / `grain_class_acc` compute the fixed-grid PR-AUC: classifier
thresholds sweep sigmoid probability 1..0 in 10 steps; the regressor's
grain-event PR sweeps predicted absolute area over [1e-4, 1e-3]."""

from __future__ import annotations

from typing import Dict, List

import numpy as np


def _sigmoid(x):
    return 1.0 / (1.0 + np.exp(-x))


def _pr_auc(y: np.ndarray, positive: np.ndarray):
    """positive: boolean prediction per threshold step [T, N]."""
    AUC, left = 0.0, 0.0
    P_list, R_list = [], []
    for pos in positive:
        tp = float(np.sum((y == 1) & pos))
        fp = float(np.sum((y == 0) & pos))
        fn = float(np.sum((y == 1) & ~pos))
        if tp + fp > 0 and tp + fn > 0:
            p = tp / (tp + fp)
            r = tp / (tp + fn)
            AUC += (r - left) * p
            left = r
        else:
            p = r = -1.0
        P_list.append(p)
        R_list.append(r)
    return AUC, P_list, R_list


def class_acc(prob_logits: np.ndarray, y: np.ndarray, intervals: int = 10):
    """Edge-event PR-AUC. prob_logits are raw logits."""
    prob = _sigmoid(np.asarray(prob_logits, np.float64))
    y = np.asarray(y)
    thresholds = [1 - i / intervals for i in range(intervals + 1)]
    positive = np.stack([prob > t for t in thresholds])
    return _pr_auc(y, positive)


def grain_class_acc(area_pred: np.ndarray, y: np.ndarray):
    """Grain-event PR-AUC over absolute-area thresholds:
    a grain is predicted eliminated when its predicted area drops below the
    threshold."""
    area_pred = np.asarray(area_pred, np.float64)
    y = np.asarray(y)
    thresholds = [1e-4, 2e-4, 4e-4, 6e-4, 8e-4, 1e-3]
    positive = np.stack([area_pred < t for t in thresholds])
    return _pr_auc(y, positive)


class FeatureMetric:
    """Accumulates per-feature masked squared errors across eval batches and
    prints percent relative errors per epoch."""

    def __init__(self, model_type: str):
        self.model_type = model_type
        self.err: Dict[str, float] = {}
        self.ref: Dict[str, float] = {}
        self.prob: List[np.ndarray] = []
        self.label: List[np.ndarray] = []
        self.auc_history: List[float] = []

    def record(self, y_dict, pred, sample_np, first_epoch: bool):
        """All inputs are numpy (or numpy-convertible) with optional leading
        batch dims; masks follow the GraphSample layout."""

        def acc(key, idx, y, p, mask):
            name = f"{key}{idx}"
            se = float(np.sum(mask * (y[..., idx] - p[..., idx]) ** 2))
            self.err[name + "err"] = self.err.get(name + "err", 0.0) + se
            if first_epoch:
                self.ref[name] = self.ref.get(name, 0.0) + float(
                    np.sum(mask * y[..., idx] ** 2)
                )

        if self.model_type == "regressor":
            gm = np.asarray(sample_np["grain_mask"])
            jm = np.asarray(sample_np["joint_mask"])
            acc("grain", 0, np.asarray(sample_np["y_grain"]), np.asarray(pred["grain"]), gm)
            acc("grain", 1, np.asarray(sample_np["y_grain"]), np.asarray(pred["grain"]), gm)
            acc("joint", 0, np.asarray(sample_np["y_joint"]), np.asarray(pred["joint"]), jm)
            acc("joint", 1, np.asarray(sample_np["y_joint"]), np.asarray(pred["joint"]), jm)
            live = gm.reshape(-1) > 0
            self.prob.append(np.asarray(pred["grain_area"]).reshape(-1)[live])
            self.label.append(np.asarray(sample_np["y_grain_event"]).reshape(-1)[live])
        else:
            y = np.asarray(sample_np["y_edge_event"]).reshape(-1)
            z = np.asarray(pred["edge_event"]).reshape(-1)
            valid = y > -1
            self.prob.append(z[valid])
            self.label.append(y[valid])

    def epoch_summary(self, verbose: bool = True):
        out = {}
        if self.model_type == "regressor":
            for name, label in (
                ("joint0", "joint x"), ("joint1", "joint y"),
                ("grain0", "grain s"), ("grain1", "grain v"),
            ):
                denom = max(self.ref.get(name, 0.0), 1e-30)
                out[label] = 100.0 * float(np.sqrt(self.err.get(name + "err", 0.0) / denom))
                self.err[name + "err"] = 0.0
            auc, plist, rlist = grain_class_acc(
                np.concatenate(self.prob), np.concatenate(self.label)
            )
        else:
            auc, plist, rlist = class_acc(
                np.concatenate(self.prob), np.concatenate(self.label)
            )
        self.plist, self.rlist = plist, rlist
        self.auc_history.append(auc)
        out["PR_AUC"] = auc
        if verbose:
            if self.model_type == "regressor":
                print(
                    "err, joint x: %2.1f, y: %2.1f, grain s: %2.1f, v: %2.1f"
                    % (out["joint x"], out["joint y"], out["grain s"], out["grain v"])
                )
            print("Validation AUC: %.6f" % auc)
        self.prob, self.label = [], []
        return out

    def optimal_threshold(self):
        """argmax(P+R) over the classifier PR sweep."""
        idx = max(
            range(len(self.plist)), key=lambda i: self.plist[i] + self.rlist[i]
        )
        thr = 1 - idx / (len(self.plist) - 1)
        return thr, self.plist[idx], self.rlist[idx]


def edge_error_metric(true_edges, pred_edges):
    """Set-IoU errors of undirected jj / jg edge sets."""

    def unordered(e):
        return set(map(tuple, np.asarray(e).T.tolist()))

    t, p = unordered(true_edges), unordered(pred_edges)
    return 1 - len(t & p) / max(len(t), 1)
