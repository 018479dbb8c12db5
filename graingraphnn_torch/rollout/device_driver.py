"""Driver of the device-resident rollout: the starting graph, the
patch-rescaled starting state and the run with its quantities of
interest.

`generate_trajectory` makes the starting graph of any (lxd, seed, G, R)
with the seeded Voronoi generator (data.extraction); `load_trajectory`
reads the committed 120 um one; `trajectory_from_extractor` takes any
extractor's first frame, a phase-field (PF) one's with its truth. For
domains larger than the 40 um training patch, local geometry is scaled
to the training distribution, with per-joint offsets kept for
reconstruction in global coordinates.
`run_device_resident` advances the spans on the device in chunks of
`eval_every` (rollout.device_rollout) and pulls the state to the host
between chunks for the QoIs (rollout.qoi) and the planar reconstruction
(graph.planar: the grain polygons rebuilt from the junction incidence
and, with reconstruct=True, rasterised), both inside the timed loop.

Scope: the periodic boundary, with nucleation and the moving melt pool,
and with compare=True the PF truth's layer error, event hits and
size-distribution KS. With partition=D it runs on each of D ranks of a
parallel.mesh.launch as the partitioned rollout
(parallel.partitioned_rollout), static and nucleation-free.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..graph import schema
from ..graph.planar import PlanarGraph
from . import device_rollout as dr
from . import topology_jit as tj
from .qoi import (event_hit_rate, misorientation_curve, size_distribution_ks,
                  volume_graph, volume_truth)

TRAIN_DELTA_Z = 0.4   # layer height of one training frame
NUCLEATION_SLACK = 256

FIXTURE_120 = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "gen120_seed5.npz")


def load_fixture(path: str = FIXTURE_120):
    """The committed starting graph: (x, edges, mask, lxd, patch_size),
    the host arrays init_scaled_state takes. FIXTURE_120 is the 120 um
    generate-mode Voronoi graph, seed 5, G=1.904, R=0.558 (~1043 grains,
    2086 junctions)."""
    with np.load(path) as z:
        x = {"grain": z["x_grain"], "joint": z["x_joint"]}
        edges = {"pull": z["edges_pull"], "connect": z["edges_connect"]}
        mask = {"grain": z["mask_grain"],
                "joint": np.ones(len(z["x_joint"]), np.int32)}
        return x, edges, mask, float(z["lxd"]), float(z["patch_size"])


@dataclasses.dataclass
class Trajectory:
    """A starting graph with the metadata the driver reads and, from a PF
    extractor, the truth compare=True reads."""
    x: Dict[str, np.ndarray]
    edges: Dict[str, np.ndarray]
    mask: Dict[str, np.ndarray]
    lxd: float
    patch_size: float
    theta_z: np.ndarray      # [num_regions + 1] orientation of each grain id
    area0: Dict              # frame-0 pixel count by grain id
    num_regions: int
    mesh_size: float
    ini_height: float
    final_height: float
    G: float
    R: float
    seed: int
    bc: str
    lyd: float
    imagesize: Tuple[int, int]   # the frame-0 raster's (x, y) size
    # the PF truth: grain ids [x, y, PF frame], eliminated grain ids of each
    # PF frame, volumes [num_regions, PF frame], training frames a PF frame
    alpha_pde_frames: Optional[np.ndarray] = None
    grain_events: Optional[list] = None
    totalV_frames: Optional[np.ndarray] = None
    extraV_frames: Optional[np.ndarray] = None
    frame_ratio: int = 1


def trajectory_from_extractor(traj, hg0) -> Trajectory:
    """The Trajectory of an extractor (data.extraction, generate or PF
    mode) and its t=0 sample (make_test_sample), with the fixture's
    dtypes; a PF extractor's truth comes along."""
    pull, connect = schema.EDGE_TYPES[1], schema.EDGE_TYPES[2]
    x_joint = np.asarray(hg0.feature_dicts["joint"], np.float64)
    area0 = traj.area_traj[0]
    return Trajectory(
        x={"grain": np.asarray(hg0.feature_dicts["grain"], np.float64),
           "joint": x_joint},
        edges={"pull": np.asarray(hg0.edge_index_dicts[pull], np.int32),
               "connect": np.asarray(hg0.edge_index_dicts[connect],
                                     np.int32)},
        mask={"grain": np.asarray(hg0.mask["grain"], np.int32).reshape(-1),
              "joint": np.ones(len(x_joint), np.int32)},
        lxd=float(traj.lxd), patch_size=float(traj.patch_size),
        theta_z=np.asarray(traj.theta_z, np.float64),
        area0=dict(zip(np.asarray(list(area0), np.int64),
                       np.asarray(list(area0.values()), np.int64))),
        num_regions=int(traj.num_regions), mesh_size=float(traj.mesh_size),
        ini_height=float(traj.ini_height),
        final_height=float(traj.final_height),
        G=float(traj.physical_params["G"]),
        R=float(traj.physical_params["R"]), seed=int(traj.seed),
        bc=traj.BC, lyd=float(traj.lyd), imagesize=tuple(traj.imagesize),
        alpha_pde_frames=getattr(traj, "alpha_pde_frames", None),
        grain_events=list(traj.grain_events) or None,
        totalV_frames=getattr(traj, "totalV_frames", None),
        extraV_frames=getattr(traj, "extraV_frames", None),
        frame_ratio=int(getattr(traj, "train_test_frame_ratio", 1)))


def generate_trajectory(lxd: float, seed: int, G: float, R: float,
                        span: int = 6) -> Trajectory:
    """The generate-mode starting graph of (lxd, seed, G, R): the seeded
    periodic Voronoi microstructure, its frame-0 areas from the raster,
    tensorised and made the t=0 sample with window `span`."""
    from ..data import extraction

    traj = extraction.generate(lxd, seed, G, R)
    return trajectory_from_extractor(
        traj, extraction.make_test_sample(traj, span=span))


def load_trajectory(path: str = FIXTURE_120) -> Trajectory:
    """The committed starting graph with its trajectory metadata (a
    periodic, square domain)."""
    x, edges, mask, lxd, patch = load_fixture(path)
    with np.load(path) as z:
        side = int(lxd / float(z["mesh_size"])) + 1
        return Trajectory(
            x=x, edges=edges, mask=mask, lxd=lxd, patch_size=patch,
            theta_z=z["theta_z"], area0=dict(zip(z["area_ids"],
                                                 z["area_counts"])),
            num_regions=int(z["num_regions"]), mesh_size=float(z["mesh_size"]),
            ini_height=float(z["ini_height"]),
            final_height=float(z["final_height"]), G=float(z["G"]),
            R=float(z["R"]), seed=int(z["seed"]), bc="periodic", lyd=lxd,
            imagesize=(side, side))


def init_scaled_state(x: Dict[str, np.ndarray], edges: Dict[str, np.ndarray],
                      mask: Dict[str, np.ndarray], lxd: float,
                      patch_size: float, *, pp_cap=None,
                      incremental: bool = False,
                      nucleation_slack: int = 0, device="cuda"):
    """Patch-rescaled device state from host arrays (float64 features,
    E_pq/E_pp COO, masks); incremental as init_device_state takes it.
    Returns (state, offset_j, domain_factor)."""
    x = {k: np.array(v, dtype=np.float64) for k, v in x.items()}
    connect = np.asarray(edges["connect"], np.int64)
    edges = {"pull": np.asarray(edges["pull"], np.int64),
             "connect": connect[:, connect[0] > -1]}
    domain_factor = lxd / patch_size
    offset_j = np.zeros((len(x["joint"]), 2))
    if domain_factor > 1:
        x["grain"][:, :2] *= domain_factor
        x["joint"][:, :2] *= domain_factor
        offset_j = np.floor(x["joint"][:, :2])
        x["joint"][:, :2] -= offset_j
        x["grain"][:, :2] -= x["grain"][:, :2] - x["grain"][:, :2] % 1
    st = dr.init_device_state(
        {k: v.astype(np.float32) for k, v in x.items()}, edges, mask,
        pp_cap=pp_cap, incremental=incremental,
        nucleation_slack=nucleation_slack, device=device)
    return st, offset_j, domain_factor


def make_melt_term(meltpool: Dict, lxd: float, span: int, n_joint_rows: int,
                   offset_j: np.ndarray, domain_factor: float, device):
    """melt_stage's parameters for meltpool = {r0, z0, melt_pool_angle}:
    the window's width `win` and its advance per span `gap`, in units of
    the domain. Returns (melt_term, gap)."""
    angle = meltpool["melt_pool_angle"]
    gap = span * TRAIN_DELTA_Z * np.cos(angle) ** 2 / np.tan(angle) / lxd
    win = (meltpool["r0"] - meltpool["z0"]) / np.tan(angle) / lxd
    off_x = np.zeros(n_joint_rows, np.float32)
    off_x[: len(offset_j)] = offset_j[:, 0]
    return {
        "r0": float(meltpool["r0"]), "z0": float(meltpool["z0"]),
        "win": float(win), "gap": float(gap),
        "domain_factor": float(max(domain_factor, 1)),
        "offset_x": torch.from_numpy(off_x).to(device),
        "n_off": int(len(offset_j)),
    }, gap


def run_device_resident(
    traj: Trajectory,
    regressor,
    classifier,
    *,
    span: int = 6,
    r_threshold: float = 1e-4,
    c_threshold: float = 0.6,
    eval_every: int = 1,
    compare: bool = False,
    reconstruct: bool = True,
    growth_height: float = -1.0,
    reconst_mesh_size: float = 0.08,
    verbose: bool = False,
    nucleation_density: float = 0.0,
    seed: int = 0,
    partition: int = 0,
    meltpool: Optional[Dict] = None,
    pallas=False,
    device="cuda",
) -> Dict:
    """Rollout of traj's starting graph with the models on `device`:
    spans run on the device in chunks of eval_every (a last partial chunk
    runs whole), and areas and excess volumes are pulled after each
    chunk. nucleation_density > 0 nucleates (per-joint uniform
    draws from numpy.random.default_rng(seed), taken per chunk at the joint
    rows' capacity); meltpool = {r0, z0, melt_pool_angle} sweeps the moving
    melt pool across the domain, which sets the number of spans. Each
    observation (frame 0, then after every chunk) rebuilds the planar
    graph from E_pq/E_pp and, with reconstruct=True, rasterises it at
    reconst_mesh_size. compare=True holds each observation's raster
    against the PF truth's frame (layer error; frame 0 the baseline), the
    predicted eliminations against the truth's, and the last volumes'
    size distribution against the truth's (KS); it needs traj's PF truth.
    Returns the result dict (event counts and hits, layer errors,
    elimination-budget deferrals, live grains, misorientation per observed
    layer, and with compare the KS).

    partition=D runs the partitioned rollout on this rank of a group of D
    ranks (call it on every rank of a parallel.mesh.launch; the state
    lives on the rank's device, not on `device`): the halo-striped
    forward, the column-sharded editor and the shared finalize, striped
    by physical x where the domain is rescaled. Rank 0 observes and
    returns the result dict, the other ranks None.

    pallas=True (or "bf16") runs the forwards on the bf16 kernels
    (device_rollout._pallas_mode), on the single-device rollout only."""
    if compare and traj.alpha_pde_frames is None:
        raise ValueError("compare=True needs a trajectory with a phase-field "
                         "truth (trajectory_from_extractor of a PF "
                         "extractor)")
    mesh = None
    if partition:
        if nucleation_density > 0 or meltpool is not None:
            raise ValueError("--partition covers the nucleation-free "
                             "static-meltpool rollout; nucleation and the "
                             "moving melt pool run on the single-device "
                             "rollout")
        if pallas:
            raise ValueError("--partition uses the striped XLA forward; "
                             "--pallas applies to the single-device scan")
        from ..parallel import mesh as mesh_mod

        mesh = mesh_mod.current(partition)
        device = mesh.device
    lead = mesh is None or mesh.rank == 0
    if traj.bc != "periodic":
        raise ValueError("the device-resident rollout covers the periodic "
                         "boundary only")
    nuc = nucleation_density > 0
    st, offset_j, domain_factor = init_scaled_state(
        traj.x, traj.edges, traj.mask, traj.lxd, traj.patch_size,
        nucleation_slack=NUCLEATION_SLACK if nuc else 0, device=device)
    device = st.xg.device
    nuc_rng = np.random.default_rng(seed)
    s_full = traj.patch_size / traj.mesh_size + 1

    final_height = (traj.ini_height + growth_height if growth_height > 0
                    else traj.final_height)
    frames_total = int((final_height - traj.ini_height) / TRAIN_DELTA_Z) + 1
    melt_term, melt_gap = None, 0.0
    if meltpool is not None:
        melt_term, melt_gap = make_melt_term(
            meltpool, traj.lxd, span, st.xj.shape[0], offset_j,
            domain_factor, device)
        frames_total = int(np.floor((1 - melt_term["win"]) / melt_gap)) \
            * span + 1
    frames = list(range(span, frames_total, span))
    frame_ratio = traj.frame_ratio
    events_truth_sets = traj.grain_events or [set()] * frames_total

    area_traj = [dict(traj.area0)]
    extraV_traj = []
    layer_err_list = []
    grain_event_list: list = []
    grain_acc_list = [(traj.ini_height, 0, 0, 0)]
    pg = PlanarGraph(bc=traj.bc, imagesize=traj.imagesize)
    pg.raise_err = False
    imagesize = ((int(traj.lxd / reconst_mesh_size) + 1,
                  int(traj.lyd / reconst_mesh_size) + 1)
                 if reconstruct else (0, 0))

    def observe(state: dr.DeviceRolloutState, frame: int):
        """Areas and excess volumes of the live grains, the planar graph
        rebuilt (and rasterised) from the junction incidence, and with
        compare the raster's layer error against the truth's frame, on the
        host."""
        xg = state.xg.cpu().numpy().astype(np.float64)
        xj = state.xj.cpu().numpy().astype(np.float64)
        mg = state.mask_g.cpu().numpy()
        mj = state.mask_j.cpu().numpy()
        E_pq = state.E_pq.cpu().numpy()
        E_pp = state.E_pp.cpu().numpy()
        area_sum = np.sum(xg[:, 3] * mg) / (traj.lxd / traj.patch_size) ** 2
        live = np.nonzero(mg > 0)[0]
        area = xg[live, 3] * s_full ** 2 / area_sum
        extraV_traj.append(
            mg * xg[:, 4] / schema.TARGET_SCALING["grain"] * s_full ** 3)
        if frame > 0:
            area_traj.append(dict(zip((live + 1).tolist(), area)))

        pos_j = xj[:, :2].copy()
        if domain_factor > 1:
            n = len(offset_j)
            pos_j[:n] = (pos_j[:n] + offset_j) / domain_factor
        pg.vertices = {int(i): pos_j[i].tolist()
                       for i in np.nonzero(mj == 1)[0]}
        v2j: Dict[int, set] = {}
        for j, g in E_pq[:, E_pq[0] >= 0].T.tolist():
            v2j.setdefault(j, set()).add(g + 1)
        pg.joint2vertex = {tuple(sorted(v)): k for k, v in v2j.items()}
        pg.vertex2joint = {v: k for k, v in pg.joint2vertex.items()}
        pg.edges = E_pp[:, E_pp[0] >= 0].T.tolist()
        pg.rebuild_regions()
        if reconstruct:
            pg.rasterize(imagesize)
        if compare:
            t_idx = min(frame // frame_ratio,
                        traj.alpha_pde_frames.shape[2] - 1)
            pg.layer_error(traj.alpha_pde_frames[:, :, t_idx].T)
            layer_err_list.append((traj.ini_height + frame * TRAIN_DELTA_Z,
                                   pg.error_layer))
            if verbose:
                print(f"frame {frame}: layer error {pg.error_layer:.4f}")

    nuc_density_term = (nucleation_density * traj.lxd * traj.lxd
                        * TRAIN_DELTA_Z if nuc else 0.0)
    if mesh is not None:
        from ..parallel import partitioned_rollout as pro

        # stripe by physical x: the scaled torus keeps the 40 um
        # interaction range whatever the domain (PartitionedRollout)
        roll = pro.PartitionedRollout(
            regressor.to(device).eval(), classifier.to(device).eval(), mesh,
            span=span, r_threshold=r_threshold, c_threshold=c_threshold,
            stripe_offsets=pro.stripe_offsets(traj.x["grain"], offset_j,
                                              domain_factor))

        def run_chunk(s, melt_lefts=None):
            return roll.run(s, eval_every)
    else:
        run_chunk = dr.make_rollout(
            regressor, classifier, n_steps=eval_every,
            r_threshold=r_threshold, c_threshold=c_threshold, span=span,
            nuc_density_term=nuc_density_term, melt_term=melt_term,
            pallas=pallas)

    def host(a):
        return a.cpu().numpy() if isinstance(a, torch.Tensor) else a

    if lead:
        observe(st, 0)
    t0 = time.time()
    saturated_steps = 0
    done = 0
    NJcap = st.xj.shape[0]
    while done < len(frames):
        melt_lefts = None
        if melt_term is not None:
            # the window advances by `gap` after each span: span t of the
            # run sits at t * gap
            melt_lefts = torch.from_numpy(
                ((done + np.arange(eval_every)) * melt_gap)
                .astype(np.float32)).to(device)
        if nuc:
            rand = nuc_rng.random((eval_every, NJcap)).astype(np.float32)
            angles = nuc_rng.random(
                (eval_every, tj.MAX_NUC, 2)).astype(np.float32)
            st, aux = run_chunk(st, torch.from_numpy(rand).to(device),
                                torch.from_numpy(angles).to(device),
                                melt_lefts)
        else:
            st, aux = run_chunk(st, melt_lefts=melt_lefts)
        ge, extra = host(aux["grain_events"]), host(aux["extra_events"])
        saturated_steps += int(host(aux["elim_saturated"]).sum())

        steps_here = min(eval_every, len(frames) - done)
        for k in range(steps_here):
            grain_event_list.extend(int(g) for g in ge[k] if g >= 0)
            grain_event_list.extend(int(g) for g in extra[k] if g >= 0)
        done += steps_here
        frame = frames[done - 1]
        if not lead:
            continue
        observe(st, frame)
        truth = set()
        for s_ in events_truth_sets[: frame // frame_ratio + 1]:
            truth |= set(s_)
        truth = {int(i) - 1 for i in truth}
        tp, n_truth, n_pred = event_hit_rate(set(grain_event_list), truth)
        height = traj.ini_height + frame * TRAIN_DELTA_Z
        grain_acc_list.append((height, n_truth, n_pred, tp))
        if verbose:
            print(f"frame {frame}: events {tp}/{n_truth} (pred {n_pred})")
    elapsed = time.time() - t0
    if not lead:
        return None

    result = {
        "inference_time": elapsed,
        "grain_acc_list": grain_acc_list,
        "layer_err_list": layer_err_list,
        "final_layer_error": layer_err_list[-1][1] if layer_err_list else None,
        "mean_layer_error": (float(np.mean([e for _, e in layer_err_list]))
                             if layer_err_list else None),
        "events_tp": grain_acc_list[-1][3],
        "events_truth": grain_acc_list[-1][1],
        "events_pred": grain_acc_list[-1][2],
        "elim_saturated_steps": saturated_steps,
        "num_grains_live": int(st.mask_g.sum()),
    }
    delta_h = ((final_height - traj.ini_height) / traj.mesh_size
               / (frames_total - 1) * span * eval_every)
    # nucleation grows the grain ids mid-rollout: the volume arrays take
    # the largest snapshot, and a nucleated grain's orientation comes back
    # from the final state (grain column 5 = cos theta)
    n_vol = max([traj.num_regions] + [len(v) for v in extraV_traj])
    vol_pred = volume_graph(area_traj, extraV_traj, n_vol, delta_h)
    theta_z = np.asarray(traj.theta_z)
    theta_pad = np.zeros(n_vol + 1)
    theta_pad[: len(theta_z)] = theta_z
    if n_vol + 1 > len(theta_z):
        new_rows = st.xg.cpu().numpy()[len(theta_z) - 1: n_vol, 5]
        theta_pad[len(theta_z):] = np.arccos(np.clip(new_rows, -1.0, 1.0))
    result["misorientation"] = misorientation_curve(theta_pad, vol_pred)
    if compare and traj.totalV_frames is not None:
        vol_truth = volume_truth(
            traj.totalV_frames, traj.extraV_frames, span, frames_total,
            traj.ini_height, final_height, traj.mesh_size,
            traj.imagesize[0], frame_ratio)
        ks, p, err_mu = size_distribution_ks(vol_pred[-1], vol_truth[-1],
                                             traj.mesh_size)
        result.update({"KS": ks, "KS_p": p, "size_err": err_mu})
    return result
