"""3D visualization: cross-section grain-id fields stacked into a volume
and written as legacy VTK files that ParaView reads.

`GrainVisual.graph_recon` stacks the rollout's predicted cross-sections
(cli.test --plot3D), `load` exports a PF file's full 3D field and
`reconstruct` stacks the PF truth's cross-sections (or given fields). The writer is a
dependency-free ASCII STRUCTURED_POINTS writer; h5py is imported only to
read PF files.
"""

from __future__ import annotations

import glob
import math
import re
from typing import Optional, Sequence

import numpy as np


def write_vtk_structured_points(
    path: str,
    scalars: np.ndarray,     # [nx, ny, nz]
    spacing=(1.0, 1.0, 1.0),
    origin=(0.0, 0.0, 0.0),
    name: str = "theta_z",
):
    """A legacy-format ASCII VTK file of scalars [nx, ny, nz], point data
    in Fortran order. Returns path."""
    nx, ny, nz = scalars.shape
    with open(path, "w") as f:
        f.write("# vtk DataFile Version 3.0\n")
        f.write("graingraphnn_tpu volume\n")
        f.write("ASCII\n")
        f.write("DATASET STRUCTURED_POINTS\n")
        f.write(f"DIMENSIONS {nx} {ny} {nz}\n")
        f.write(f"ORIGIN {origin[0]} {origin[1]} {origin[2]}\n")
        f.write(f"SPACING {spacing[0]} {spacing[1]} {spacing[2]}\n")
        f.write(f"POINT_DATA {nx * ny * nz}\n")
        f.write(f"SCALARS {name} float 1\n")
        f.write("LOOKUP_TABLE default\n")
        flat = scalars.ravel(order="F")
        np.savetxt(f, flat.reshape(-1, 1), fmt="%.4f")
    return path


class GrainVisual:
    """3D grain-structure exports of one seed's build of `height` um."""

    def __init__(self, lxd: float = 40, seed: int = 1, height: float = 50,
                 base_width: float = 2):
        self.lxd = lxd
        self.seed = seed
        self.height = height
        self.base_width = base_width

    def _load_h5(self, rawdat_dir, cache_dir="./data_cache"):
        import h5py

        path = sorted(glob.glob(rawdat_dir + "/*seed" + str(self.seed) + "_*"))[0]
        if path.endswith(".gz"):
            from ..data.extraction import maybe_gunzip

            path = maybe_gunzip(path, cache_dir)
        f = h5py.File(path, "r")
        x = np.asarray(f["x_coordinates"])
        angles = np.asarray(f["angles"])
        theta_z = np.zeros(1 + len(angles) // 2)
        theta_z[1:] = angles[len(angles) // 2 + 1:]
        return f, path, x, theta_z

    def load(self, rawdat_dir: str = "./", out: Optional[str] = None):
        """The PF file's full 3D field (`alpha`) up to self.height, coloured
        by theta_z in degrees, as rawdat_dir/seed<seed>.vtk (or out)."""
        f, path, x, theta_z = self._load_h5(rawdat_dir)
        with f:
            dx = x[1] - x[0]
            fnx, fny = len(x), len(np.asarray(f["y_coordinates"]))
            fnz = len(np.asarray(f["z_coordinates"]))
            alpha = np.asarray(f["alpha"]).reshape((fnx, fny, fnz), order="F")
        top_z = int(np.round(self.height / dx))
        alpha = alpha[1:-1, 1:-1, 1:top_z]
        vol = theta_z[alpha] / math.pi * 180
        out = out or f"{rawdat_dir}/seed{self.seed}.vtk"
        return write_vtk_structured_points(out, vol, spacing=(dx, dx, dx))

    def reconstruct(
        self,
        rawdat_dir: str = "./",
        span: int = 6,
        alpha_field_list: Optional[Sequence[np.ndarray]] = None,
        out: Optional[str] = None,
    ):
        """The PF truth's cross-sections (the file's `cross_sec`, one plane
        a frame, every span-th) stacked into a volume whose planes lie one
        span's growth apart, coloured by theta_z in degrees, as
        rawdat_dir/seed<seed>leapz.vtk (or out). With alpha_field_list,
        those fields are stacked instead."""
        f, path, x, theta_z = self._load_h5(rawdat_dir)
        with f:
            dx = x[1] - x[0]
            fnx, fny = len(x), len(np.asarray(f["y_coordinates"]))
            m = re.search(r"frames(\d+)", path)
            data_frames = (int(m.group(1)) + 1) if m else 121
            if alpha_field_list:
                vol = np.stack(alpha_field_list, axis=2)
            else:
                vol = np.asarray(f["cross_sec"]).reshape(
                    (fnx, fny, data_frames), order="F")[1:-1, 1:-1, ::span]
        dx_frame = (50 - self.base_width) / (data_frames - 1) * span
        top_z = int(np.round((self.height - self.base_width) / dx_frame)) + 1
        vol = theta_z[vol[:, :, :top_z]] / math.pi * 180
        out = out or f"{rawdat_dir}/seed{self.seed}leapz.vtk"
        return write_vtk_structured_points(out, vol,
                                           spacing=(dx, dx, dx_frame))

    def graph_recon(
        self,
        theta_z: np.ndarray,
        alpha_field_list: Sequence[np.ndarray],
        span: int,
        frames: int,
        mesh_size: float,
        ini_height: float,
        final_height: float,
        out: str,
    ):
        """The rollout's cross-section id fields stacked into a volume
        coloured by theta_z in degrees, written to out."""
        vol = np.stack(alpha_field_list, axis=2)
        dx_frame = (self.height - self.base_width) / (frames - 1) * span
        top_z = int(np.round((final_height - ini_height) / dx_frame)) + 1
        vol = vol[:, :, :top_z]
        vol = theta_z[vol] / math.pi * 180
        return write_vtk_structured_points(
            out, vol, spacing=(mesh_size, mesh_size, dx_frame))
