"""Analytic thermal profiles and the random (G, R) schedule of temporal
rollouts (reference TemperatureProfile3DAnalytic.py).

The engine's `temporal=True` reads `gr_sequence_from_time`: a random
Fourier series gives G(t), R(t), mapped to the build height of each
span (graph_trajectory.GR_seq_from_time, :129-173). numpy and scipy only.
"""

from __future__ import annotations

import math

import numpy as np
from scipy.interpolate import interp1d


class ThermalProfile:
    """Distance-to-solidification-front profiles for line / cylinder /
    sphere melt pools (TemperatureProfile3DAnalytic.py:12-87)."""

    def __init__(self, domain_size, thermal, seed=0):
        self.lx, self.ly, self.lz = domain_size
        self.G, self.R, self.U = thermal
        self.seed = seed

    @staticmethod
    def rand_gr(t, t_end, t_sampling_freq):
        """Random Fourier series -> G in [0.5, 10] K/um, R in [0.2, 2] m/s
        (TemperatureProfile3DAnalytic.py:19-43). Consumes np.random in
        reference order."""
        freqs = np.arange(1, t_sampling_freq + 1) / t_end * math.pi / 2
        g_coeff = np.random.rand(len(freqs))
        g_phase = np.random.rand(len(freqs)) * 2 * math.pi
        r_coeff = np.random.rand(len(freqs))
        r_phase = np.random.rand(len(freqs)) * 2 * math.pi

        G = np.zeros(len(t))
        R = np.zeros(len(t))
        for i in range(t_sampling_freq):
            G += g_coeff[i] * np.cos(freqs[i] * t + g_phase[i]) / (i + 1)
            R += r_coeff[i] * np.sin(freqs[i] * t + r_phase[i]) / (i + 1)
        G = 0.5 + 9.5 * (G - G.min()) / (G.max() - G.min())
        R = 0.2 + 1.8 * (R - R.min()) / (R.max() - R.min())
        return G, R

    def pointwise_temp_const_gr(self, profile, x, y, z, t, z0=0, r0=0):
        return -self.G * self.dist_to_interface(profile, x, y, z, z0, r0) - self.U * t * 1e6

    def dist_to_interface(self, profile, x, y, z, z0=0, r0=0):
        if profile == "uniform":
            return -10
        if profile == "line":
            return z0 - z
        if profile == "cylinder":
            yc, zc = self.ly / 2, self.lz
            return np.sqrt((y - yc) ** 2 + (z - z0 - zc) ** 2) - r0
        if profile == "sphere4":
            xc, yc, zc = self.lx, self.ly / 2, self.lz
            return np.sqrt((x - xc) ** 2 + (y - yc) ** 2 + (z + z0 - zc) ** 2) - r0
        if profile == "sphere8":
            xc, yc, zc = self.lx, self.ly, self.lz
            return np.sqrt((x - xc) ** 2 + (y - yc) ** 2 + (z + z0 - zc) ** 2) - r0
        raise KeyError(profile)


def gr_sequence_from_time(seed, freq, delta_z, counts, ini_height, final_height,
                          min_r=0.2):
    """G, R per inference step for temporal (varying-G/R) rollouts
    (graph_trajectory.GR_seq_from_time, :129-155)."""
    np.random.seed(seed)
    t_end = (final_height - ini_height) / min_r
    t = np.linspace(0, t_end, 501)
    g_rand, r_rand = ThermalProfile.rand_gr(t, t_end, freq)
    z_sam = np.zeros(len(r_rand))
    z_sam[1:] = 0.5 * np.cumsum(r_rand[1:] + r_rand[:-1]) * (t[1] - t[0])
    # `counts` (the number of inference steps) is authoritative — the
    # reference asserts the rounded height ratio matches, which fails for
    # heights that don't divide cleanly in binary floating point
    z_eq = delta_z * np.arange(0.5, counts)
    g_list = interp1d(z_sam, g_rand)(z_eq)
    r_list = interp1d(z_sam, r_rand)(z_eq)
    assert len(g_list) == counts and len(r_list) == counts
    return g_list, r_list


def default_generate_config() -> dict:
    """User-facing config for generate-mode inference
    (user_generate.user_defined_config, :9-40)."""
    return {
        "meltpool": "line",
        "boundary": "noflux",
        "geometry": {
            "lxd": 40, "yx_asp_ratio": 1, "zx_asp_ratio": 1.2,
            "r0": 1, "z0": 2, "cone_ratio": 0,
        },
        "physical_parameters": {"G": 1, "R": 1},
        "initial_parameters": {
            "grain_size_mean": 4, "mesh_size": 0.08,
            "noise_level": 0.01, "seed": 1,
        },
    }


def span_from_gr_grid(grid: dict, G: float, R: float) -> int:
    """Nearest-neighbor span lookup in the shipped (G, R) -> span calibration
    grid (GR_train_grid.pkl; consumed at graph_trajectory.py:1262-1270)."""
    from scipy.interpolate import griddata

    g_ = (G - grid["G_min"]) / (grid["G_max"] - grid["G_min"])
    r_ = (R - grid["R_min"]) / (grid["R_max"] - grid["R_min"])
    span = griddata(
        np.array([grid["G"], grid["R"]]).T,
        np.array(grid["span"]),
        (g_, r_),
        method="nearest",
    )
    return int(span)


def build_gr_grid(entries) -> dict:
    """Build the calibration grid from (G, R, span) tuples
    (extract_dz_grid.py:15-55)."""
    g = [e[0] for e in entries]
    r = [e[1] for e in entries]
    span = [int(e[2]) for e in entries]
    out = {
        "G_min": min(g), "G_max": max(g),
        "R_min": min(r), "R_max": max(r),
        "span": span,
    }
    out["G"] = [(i - out["G_min"]) / (out["G_max"] - out["G_min"]) for i in g]
    out["R"] = [(i - out["R_min"]) / (out["R_max"] - out["R_min"]) for i in r]
    return out
