"""ParaView batch rendering of exported grain volumes (SURVEY row 25).

Counterpart of the reference's paraview trace scripts
(`visualization3D/grain.py`, `threshold.py`, `grain_video.py`): offscreen
renders of the `.vtk` volumes that `viz.volume.GrainVisual`
(load / reconstruct / graph_recon) writes, driven by `paraview.simple`.

Instead of three near-identical 170-line recorded GUI traces with
hardcoded cluster paths, this is one parameterized CLI:

    python -m graingraphnn_torch.viz.paraview_batch seed10020_graph.vtk \
        --out seed10020.png [--clip] [--threshold LO HI] \
        [--video --frames 30] [--resolution 1080]

ParaView is an optional, environment-specific dependency (it ships its own
Python); when `paraview.simple` is unavailable this exits with a clear
message rather than degrading silently. A copy of the JAX package's
module (it imports no JAX), so that the port stands alone.
"""

from __future__ import annotations

import argparse
import os
import sys


def build_pipeline(pv, path: str, *, clip: bool, threshold=None,
                   surface_opacity: float = 0.5):
    """Reader -> (optional threshold) -> (optional clip) -> colored render.

    Mirrors the reference pipeline: legacy VTK reader, 'alpha' (grain id)
    as the active scalar, categorical coloring, optional axis-aligned clip
    at the domain midplane (grain.py --clip) and scalar thresholding
    (threshold.py --upthresh/--lowthresh)."""
    src = pv.LegacyVTKReader(FileNames=[path])
    stage = src
    if threshold is not None:
        thr = pv.Threshold(Input=stage)
        thr.Scalars = ["POINTS", "alpha"]
        lo, hi = threshold
        if hasattr(thr, "LowerThreshold"):     # ParaView >= 5.10
            thr.LowerThreshold = lo
            thr.UpperThreshold = hi
        else:                                   # older: single range property
            thr.ThresholdRange = [lo, hi]
        stage = thr
    if clip:
        clp = pv.Clip(Input=stage)
        # default ClipType is already a Plane proxy; set its normal only
        clp.ClipType.Normal = [0.0, 1.0, 0.0]
        stage = clp
    view = pv.GetActiveViewOrCreate("RenderView")
    disp = pv.Show(stage, view)
    pv.ColorBy(disp, ("POINTS", "alpha"))
    lut = pv.GetColorTransferFunction("alpha")
    lut.ApplyPreset("Rainbow Desaturated", True)
    disp.SetRepresentationType("Surface")
    disp.Opacity = surface_opacity
    view.ResetCamera()
    return view


def render_image(pv, view, out: str, resolution: int):
    view.ViewSize = [resolution, resolution]
    pv.SaveScreenshot(out, view)


def render_video_frames(pv, view, out_prefix: str, frames: int,
                        resolution: int):
    """Orbit-camera frame sequence (reference: grain_video.py) — PNG per
    frame; stitch offline (e.g. ffmpeg)."""
    import math

    view.ViewSize = [resolution, resolution]
    cam = pv.GetActiveCamera()
    for k in range(frames):
        cam.Azimuth(360.0 / frames if k else 0.0)
        pv.Render(view)
        pv.SaveScreenshot(f"{out_prefix}_{k:04d}.png", view)
    print(f"wrote {frames} frames to {out_prefix}_*.png")


def main(argv=None):
    ap = argparse.ArgumentParser("paraview batch render")
    ap.add_argument("vtk", help=".vtk volume from viz.volume.GrainVisual")
    ap.add_argument("--out", default="", help="output png (default: <vtk>.png)")
    ap.add_argument("--clip", action="store_true",
                    help="midplane clip (reference grain.py --clip)")
    ap.add_argument("--threshold", type=float, nargs=2, metavar=("LO", "HI"),
                    help="keep grain ids in [LO, HI] (reference threshold.py)")
    ap.add_argument("--video", action="store_true",
                    help="render an orbit frame sequence instead of one png")
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--resolution", type=int, default=1080)
    ap.add_argument("--opacity", type=float, default=0.5)
    args = ap.parse_args(argv)

    try:
        import paraview.simple as pv
    except ImportError:
        sys.exit(
            "paraview.simple not importable: ParaView is an optional, "
            "environment-specific dependency (load its own Python, e.g. "
            "`pvpython`, or `module load paraview` on a cluster). The .vtk "
            "inputs themselves come from viz.volume.GrainVisual and open "
            "in the ParaView GUI directly."
        )

    pv._DisableFirstRenderCameraReset()
    thr = tuple(args.threshold) if args.threshold else None
    view = build_pipeline(pv, args.vtk, clip=args.clip, threshold=thr,
                          surface_opacity=args.opacity)
    out = args.out or os.path.splitext(args.vtk)[0] + ".png"
    if args.video:
        render_video_frames(pv, view, os.path.splitext(out)[0],
                            args.frames, args.resolution)
    else:
        render_image(pv, view, out, args.resolution)
        print(f"wrote {out}")


if __name__ == "__main__":
    main()
