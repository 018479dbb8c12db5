"""Quantities of interest for rollout evaluation
(reference graph_trajectory.py:176-280, 847-887): the port's own copy of
graingraphnn_tpu/rollout/qoi.py, numpy and scipy only.

All functions return numbers/arrays; plotting is left to callers.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import numpy as np
from scipy import stats


def volume_graph(
    area_traj: Sequence[Dict[int, float]],
    extraV_traj: Sequence[np.ndarray],
    num_regions: int,
    delta_h: float,
) -> List[np.ndarray]:
    """Per-grain volume trajectory integrated from predicted layer areas
    (trapezoid in z) + excess volume (graph_trajectory.volume mode='graph',
    :221-242). The first entry adds the underlying spherical-cap volume
    4/(3*sqrt(pi)) * area^1.5."""
    volume = np.zeros(num_regions)

    def padded(v):
        # nucleation grows the grain count mid-rollout; earlier extraV
        # snapshots are zero-padded to the final count (the reference's
        # volume() would fail on ragged trajectories here)
        out = np.zeros(num_regions)
        out[: len(v)] = v
        return out

    traj = []
    for grain, area in area_traj[0].items():
        volume[grain - 1] += 4 / 3 / math.sqrt(math.pi) * area**1.5
    traj.append(volume.copy())
    for layer, area_counts in enumerate(area_traj[1:]):
        for grain, area in area_traj[layer].items():
            volume[grain - 1] += delta_h * area / 2
        for grain, area in area_counts.items():
            volume[grain - 1] += delta_h * area / 2
        traj.append(volume.copy() + padded(extraV_traj[layer + 1]))
    return traj


def volume_truth(
    totalV_frames: np.ndarray,
    extraV_frames: np.ndarray,
    span: int,
    frames: int,
    ini_height: float,
    final_height: float,
    mesh_size: float,
    imagesize_x: int,
    frame_ratio: int = 1,
) -> List[np.ndarray]:
    """PF ground-truth volume trajectory (graph_trajectory.volume
    mode='truth', :187-212)."""
    s = imagesize_x
    area0 = totalV_frames[:, 0] / np.sum(totalV_frames[:, 0]) * s**2
    underlying = 4 / 3 / math.sqrt(math.pi) * area0**1.5
    traj = [underlying.copy()]
    for time in range(span, frames, span):
        height = ini_height + time / (frames - 1) * (final_height - ini_height)
        t = time // frame_ratio
        vol = totalV_frames[:, t] - extraV_frames[:, t]
        scale_surface = np.sum(vol) / s**2 / (height / mesh_size + 1)
        vol = vol / scale_surface
        vol = vol + underlying + extraV_frames[:, t] - area0 * (ini_height / mesh_size + 1)
        traj.append(vol.copy())
    return traj


def grain_sizes(volumes: np.ndarray, mesh_size: float) -> np.ndarray:
    """Equivalent sphere diameter per grain (graph_trajectory.py:247)."""
    return np.cbrt(6 * np.asarray(volumes) / math.pi) * mesh_size


def size_distribution_ks(pred_volumes, truth_volumes, mesh_size: float):
    """Grain-size distribution comparison: (KS statistic, p, mean err)."""
    d_p = grain_sizes(pred_volumes, mesh_size)
    d_t = grain_sizes(truth_volumes, mesh_size)
    ks, p = stats.ks_2samp(d_p, d_t)
    err_mu = abs(np.mean(d_t) - np.mean(d_p)) / np.mean(d_t)
    return float(ks), float(p), float(err_mu)


def misorientation_curve(theta_z: np.ndarray, volume_traj) -> List[float]:
    """Volume-weighted mean misorientation per layer
    (graph_trajectory.misorientation, :870-887)."""
    misangles = 45 - np.absolute(180 / math.pi * theta_z[1:] - 45)
    return [float(np.sum(misangles * v) / np.sum(v)) for v in volume_traj]


def event_hit_rate(pred_events: set, truth_events: set):
    """(true positives, truth count, predicted count)."""
    tp = len(set(pred_events) & set(truth_events))
    return tp, len(truth_events), len(pred_events)
