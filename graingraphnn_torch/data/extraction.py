"""Graph trajectories and their samples, generate mode.

`TrajectoryExtractor` owns the seeded starting graph (graph.voronoi) of
one trajectory with its thermal parameters, its per-frame states and the
event lists between frames. `make_test_sample` is the t=0 inference input,
`make_training_samples` the windowed training pairs of a trajectory whose
states and events are filled, with `calibrate_span` choosing the window.

The phase-field part of the JAX package's extraction (loading frames from
.h5 files, junction matching, event detection and repairs) is not here:
a TrajectoryExtractor is built in generate mode only.
"""

from __future__ import annotations

from typing import List

import numpy as np

from ..graph.voronoi import Microstructure
from . import heterograph


class TrajectoryExtractor(Microstructure):
    """The per-frame graph states of one trajectory and the event lists
    between frames."""

    def __init__(
        self,
        lxd: float = 40,
        seed: int = 1,
        frames: int = 121,
        noise: float = 0.01,
        bc: str = "periodic",
        adjust_grain_size: bool = False,
        adjust_grain_orien: bool = False,
        physical_params: dict | None = None,
        user_defined_config: dict | None = None,
        rand_init: bool = True,
        verbose: bool = False,
    ):
        super().__init__(
            lxd=lxd, seed=seed, noise=noise, bc=bc, rand_init=rand_init,
            adjust_grain_size=adjust_grain_size,
            adjust_grain_orien=adjust_grain_orien,
            user_defined_config=user_defined_config,
        )
        if user_defined_config:
            self.physical_params = user_defined_config["physical_parameters"]
        else:
            self.physical_params = dict(physical_params or {})
        self.joint2vertex = {tuple(sorted(v)): k
                             for k, v in self.vertex2joint.items()}
        self.frames = frames
        self.train_test_frame_ratio = 120 // (frames - 1)
        self.load_frames = frames
        self.match_graph = True
        self.verbose = verbose

        self.edge_events: List[set] = []
        self.grain_events: List[set] = []
        self.states: List[heterograph.HeteroState] = []
        self.save_frame = [True] * frames
        self.area_traj: List[dict] = []
        self.extraV_traj: List = []


def generate(lxd: float, seed: int, G: float, R: float,
             bc: str = "periodic") -> TrajectoryExtractor:
    """The generate-mode trajectory of (lxd, seed, G, R): the seeded
    Voronoi microstructure with its frame-0 areas from the raster and its
    frame-0 state (make_test_sample makes the t=0 sample of it)."""
    traj = TrajectoryExtractor(lxd=lxd, seed=seed, frames=121, bc=bc,
                               physical_params={"G": G, "R": R})
    traj.area_counts = dict(zip(*np.unique(traj.alpha_field,
                                           return_counts=True)))
    traj.area_traj.append(dict(traj.area_counts))
    traj.states.append(heterograph.tensorize(traj, 0))
    return traj


SPAN_CHOICES = (6, 8, 10, 12, 15, 20, 24, 30, 40, 60, 120)


def calibrate_span(traj: TrajectoryExtractor) -> int:
    """The largest window in SPAN_CHOICES shorter than both the edge-event
    and the grain-event spacing of the trajectory."""
    edge_e = len(set.union(*traj.edge_events)) if traj.edge_events else 0
    grain_e = len(set.union(*traj.grain_events)) if traj.grain_events else 0
    edge_step = 6 * 360 / edge_e if edge_e > 0 else 1000
    grain_step = 6 * 90 / grain_e if grain_e > 0 else 1000
    span = SPAN_CHOICES[0]
    for c in SPAN_CHOICES:
        if c < edge_step and c < grain_step:
            span = c
    return span


def make_training_samples(
    traj: TrajectoryExtractor, span: int | None = None, prev: int = 0,
    stride: int | None = None, verbose: bool = False,
) -> List[heterograph.HeteroState]:
    """Windowed training pairs with event labels and optional history
    gradients. `stride` defaults to span // 2; stride=1 gives the densest
    overlapping window set a trajectory supports."""
    span = span or calibrate_span(traj)
    stride = stride if stride is not None else max(1, span // 2)
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    samples: List[heterograph.HeteroState] = []
    success_list: List[int] = []
    cnt = 0
    for snapshot in range(0, traj.frames - span, stride):
        cnt += 1
        if not (traj.save_frame[snapshot] and traj.save_frame[snapshot + span]):
            continue
        if snapshot - span >= 0 and not traj.save_frame[snapshot - span]:
            continue
        hg = traj.states[snapshot]
        hg.span = span
        event_list = set.union(*traj.edge_events[snapshot + 1: snapshot + span + 1])
        elim_list = []
        for checkpoint in range(snapshot + 1, snapshot + span + 1):
            for grain in traj.grain_events[checkpoint]:
                elim_list.append([grain - 1, span / (checkpoint - snapshot)])
        heterograph.form_gradient(
            hg,
            prev=None if snapshot - span < 0 else traj.states[snapshot - span],
            nxt=traj.states[snapshot + span],
            event_list=event_list,
            elim_list=elim_list,
            verbose=verbose,
        )
        samples.append(hg)
        success_list.append(cnt)

    for idx, hg in enumerate(samples):
        frame = success_list[idx]
        prev_list = []
        for i in range(1, prev + 1):
            if frame - i in success_list:
                prev_list.append(samples[success_list.index(frame - i)])
            else:
                prev_list.append(None)
        heterograph.append_history(hg, prev_list)
    return samples


def make_test_sample(traj: TrajectoryExtractor,
                     span: int) -> heterograph.HeteroState:
    """The t=0 inference input: the first state with its gradient
    features (zero: no previous window) and the window `span`."""
    hg0 = traj.states[0]
    hg0.span = span
    heterograph.form_gradient(hg0, prev=None, nxt=None, event_list=None,
                              elim_list=None)
    heterograph.append_history(hg0, [])
    return hg0
