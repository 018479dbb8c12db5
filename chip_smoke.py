"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card

Phases: (1) the device, (2) building both CUDA kernels from csrc/, (3) the
fused PeriodConv edge-stage kernel against its plain version at the
rollout's three conv shapes, (4) the topology-editor kernel against its
plain version on the first span's editor inputs and on forced scenarios,
(5) a 20-span device-resident rollout of the 120 um fixture graph with the
shipped checkpoints through both kernels, with launch counts, throughput
and a CPU reference span. Prints one JSON line per phase, the kernels line,
and last {"ok": true, "device": {...}}. Any failure exits non-zero.
"""

from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

from graingraphnn_torch.kernels import _build, edge_stage, editor_fused
from graingraphnn_torch.models import cells
from graingraphnn_torch.ops import period_conv
from graingraphnn_torch.rollout import device_driver as dd
from graingraphnn_torch.rollout import device_rollout as dr
from graingraphnn_torch.rollout import topology_jit as tj
from graingraphnn_torch.train import checkpoint

N_SPANS = 20
C_THRESHOLD = 0.99
ATOL, RTOL = 1e-4, 1e-4       # fp32 kernel vs plain, sums reordered
EDITOR_ATOL = 1e-6
PEAK_FP32 = 67e12             # H100 SXM, fp32 outside the tensor cores
PEAK_BYTES = 3.35e12          # H100 SXM HBM3
REPLACES = {
    "push": "graingraphnn_tpu/kernels/edge_stage.py:58",
    "connect": "graingraphnn_tpu/kernels/edge_stage.py:58",
    "pull": "graingraphnn_tpu/kernels/edge_stage.py:156",
    "editor": "graingraphnn_tpu/kernels/editor_pallas.py:31",
}


def emit(**kw):
    print(json.dumps(kw), flush=True)


def cuda_ms(fn, n=50, warmup=3):
    """Mean device time of fn() over n calls, from CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0, t1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    t0.record()
    for _ in range(n):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / n


def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi.splitlines()[0] if smi else "nvidia-smi: no output", flush=True)
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
           "count": torch.cuda.device_count()}
    emit(phase="device", **dev, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda)
    return dev, smi


def phase_build():
    t0 = time.perf_counter()
    log = _build.build([(edge_stage.SOURCE, edge_stage.NVCC_FLAGS),
                        (editor_fused.SOURCE, editor_fused.NVCC_FLAGS)])
    emit(phase="build", seconds=time.perf_counter() - t0, sources=log)


def conv_cost(x_src, x_dst, nbr_mask, G, C):
    """(flops, bytes) the conv needs on these inputs: the shift-decomposed
    form, live edges only; each input read once, the output written once."""
    (Ns, Fs), (Nd, Fd) = x_src.shape, x_dst.shape
    GC = G * C
    live = float(nbr_mask.sum())
    K = nbr_mask.shape[1]
    flops = (2 * 2 * Ns * Fs * GC + 2 * 2 * Nd * Fd * GC
             + live * GC * (2 * C + 26))
    bytes_ = 4 * (Ns * Fs + Nd * Fd + 3 * Nd * K + 2 * (Fs + Fd) * GC
                  + G * C * C + 6 * GC + Nd * GC)
    return flops, bytes_


def bound(flops, bytes_):
    t_ops, t_bytes = flops / PEAK_FP32 * 1e3, bytes_ / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def decoder_conv_inputs(reg, sample):
    """The decoder cell's conv inputs on the first span (h from the
    encoder, as in the rollout): {name: (conv, x_src, x_dst, nbr, len,
    mask)}."""
    C = reg.hp.layer_size
    h, _c = cells.apply_pgclstm(reg.encoder[0], sample, sample.grain_x,
                                sample.joint_x, cells.zero_state(sample, C), C)
    xg = torch.cat([sample.grain_x, h["grain"]], 1).contiguous()
    xj = torch.cat([sample.joint_x, h["joint"]], 1).contiguous()
    cv = reg.decoder[0].conv
    s = sample
    return {
        "push": (cv["push"], xg, xj, s.push_nbr, s.push_len, s.push_mask),
        "connect": (cv["connect"], xj, xj, s.connect_nbr, s.connect_len,
                    s.connect_mask),
        "pull": (cv["pull"], xj, xg, s.pull_nbr, s.pull_len, s.pull_mask),
    }


def phase_edge_stage(reg, state):
    sample, _ = dr.make_sample(state)
    G, C = cells.NUM_GATES, reg.hp.layer_size
    kw = dict(num_gates=G, out_channels=C)
    rows = {}
    for name, (conv, xs, xd, nbr, ln, m) in decoder_conv_inputs(
            reg, sample).items():
        # the real masks, and a copy with every 7th row fully masked
        m_cut = m.clone()
        m_cut[::7] = 0.0
        err = rel = 0.0
        for mask in (m, m_cut):
            out = edge_stage.apply_period_conv_cuda(conv, xs, xd, nbr, ln,
                                                    mask, **kw)
            ref = period_conv.apply_period_conv_plain(conv, xs, xd, nbr, ln,
                                                      mask, **kw)
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                raise RuntimeError(f"edge stage {name}: non-finite output")
            diff = (out - ref).abs()
            tol = ATOL + RTOL * ref.abs()
            if bool((diff > tol).any()):
                raise RuntimeError(
                    f"edge stage {name}: max abs err {diff.max().item()} "
                    f"over atol {ATOL} rtol {RTOL}")
            err = max(err, diff.max().item())
            rel = max(rel, (diff / ref.abs().clamp_min(1e-3)).max().item())
        ms = cuda_ms(lambda: edge_stage.apply_period_conv_cuda(
            conv, xs, xd, nbr, ln, m, **kw))
        plain_ms = cuda_ms(lambda: period_conv.apply_period_conv_plain(
            conv, xs, xd, nbr, ln, m, **kw), n=20)
        flops, bytes_ = conv_cost(xs, xd, m, G, C)
        bound_ms, bound_by = bound(flops, bytes_)
        K = nbr.shape[1]
        rows[name] = dict(
            name=f"edge_stage_{name}", route="cuda",
            source="graingraphnn_torch/csrc/edge_stage.cu",
            replaces=REPLACES[name], shape_key=(K, xs.shape[1], xd.shape[1]),
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None,
            check=f"pass: atol {ATOL} rtol {RTOL}, also fully masked rows")
        emit(phase="edge_stage", conv=name, K=K, Ns=xs.shape[0],
             Nd=xd.shape[0], F_src=xs.shape[1], F_dst=xd.shape[1],
             live_edges=float(m.sum()), max_abs_err=err,
             max_rel_err=rel, atol=ATOL, rtol=RTOL,
             ms=ms, plain_ms=plain_ms, gflop=flops / 1e9, mbytes=bytes_ / 1e6,
             bound_ms=bound_ms, bound_by=bound_by,
             achieved_tflops=flops / ms / 1e9)
    return rows


def editor_inputs(reg, cls, state):
    """The first span's editor inputs, as edit_stage builds them."""
    sample, y_r, y_c, _ = dr.forward_stage(reg, cls, state, tj.RING_MAX)
    xg, xj = dr.integrate_stage(state, y_r["joint"], y_r["grain"], 6)
    ge, _ = dr.elim_candidates(state, y_r["grain_area"], 1e-4)
    logits = torch.where(state.E_pp[0] >= 0, y_c["edge_event"],
                         torch.full_like(y_c["edge_event"], dr.NEG))
    tstate = tj.TopoState(E_pp=state.E_pp, E_pq=state.E_pq, xj=xj,
                          y_joint=y_r["joint"], mask_g=state.mask_g,
                          mask_j=state.mask_j, append_ptr=state.n_pp)
    return tstate, logits, ge, y_r["grain"]


def forced_editor_inputs(tstate, seed, n_switch, n_elim):
    """Switches forced on random u<v edges and eliminations of the grains
    with the smallest rings (the JAX package's fused-editor test cases)."""
    rng = np.random.default_rng(seed)
    E = tstate.E_pp.cpu().numpy()
    Q = tstate.E_pq.cpu().numpy()
    logits = np.full(E.shape[1], dr.NEG, np.float32)
    logits[E[0] >= 0] = -50.0
    cand = np.nonzero((E[0] < E[1]) & (E[0] >= 0))[0]
    logits[cand[rng.choice(len(cand), n_switch, replace=False)]] = \
        rng.uniform(5.0, 15.0, n_switch)
    grains, counts = np.unique(Q[1][Q[1] >= 0], return_counts=True)
    small = grains[np.argsort(counts, kind="stable")][:12]
    ge = np.full(tj.MAX_ELIM, -1, np.int32)
    ge[:n_elim] = rng.choice(small, n_elim, replace=False)
    NG = tstate.mask_g.shape[0]
    y_grain = np.stack([rng.uniform(-0.5, 0.5, NG), np.zeros(NG)], 1)
    dev = tstate.E_pp.device
    return (tstate, torch.tensor(logits, device=dev),
            torch.tensor(ge, device=dev),
            torch.tensor(y_grain, dtype=torch.float32, device=dev))


def _to(ts, dev):
    return tj.TopoState(**{k: v.to(dev) for k, v in vars(ts).items()})


def forced_out_chain(tstate, max_grains=40):
    """Editor inputs [(state, logits, ge, y_grain)] on the CPU for a chain
    of edits that ends in a FORCED elimination: single switches shrink a
    small grain t to three sides, then a neighbour of t is eliminated with
    t's predicted darea lowest, so its ring collapse switches the edge
    shared with t first and forces t out (t lands in `extra`). Built with
    the plain editor; empty if no grain of the first `max_grains` allows
    it."""
    NG = tstate.mask_g.shape[0]

    def logits_for(st, cols):
        lg = torch.full((st.E_pp.shape[1],), dr.NEG)
        lg[st.E_pp[0] >= 0] = -50.0
        lg[cols] = 10.0
        return lg

    def ring(st, t):
        return set(st.E_pq[0][st.E_pq[1] == t].tolist())

    no_elim = torch.full((tj.MAX_ELIM,), -1, dtype=torch.int32)
    flat = torch.zeros((NG, 2))
    st0 = _to(tstate, "cpu")
    grains, counts = torch.unique(st0.E_pq[1][st0.E_pq[1] >= 0],
                                  return_counts=True)
    for t in grains[torch.argsort(counts, stable=True)][:max_grains].tolist():
        st, chain = st0, []
        while st is not None and len(ring(st, t)) > 3:
            r = ring(st, t)
            E = st.E_pp
            cols = [c for c in range(E.shape[1]) if int(E[0, c]) in r
                    and int(E[1, c]) in r and int(E[0, c]) < int(E[1, c])]
            nxt = None
            for c in cols:
                args = (st, logits_for(st, [c]), no_elim, flat)
                out = editor_fused.update_fused(*args, 0.6, NG)[0]
                if len(ring(out, t)) < len(ring(st, t)):
                    chain.append(args)
                    nxt = out
                    break
            st = nxt
        if st is None:
            continue
        nbrs = set(st.E_pq[1][torch.isin(st.E_pq[0], torch.tensor(
            sorted(ring(st, t)), dtype=st.E_pq.dtype)) & (st.E_pq[1] != t) & (st.E_pq[1] >= 0)]
            .tolist())
        yg = torch.zeros((NG, 2))
        yg[:, 0] = 0.3
        yg[t, 0] = -0.9
        for n in sorted(nbrs):
            ge = no_elim.clone()
            ge[0] = n
            args = (st, logits_for(st, []), ge, yg)
            extra = editor_fused.update_fused(*args, 0.6, NG)[2]
            if bool((extra == t).any()):
                return chain + [args]
    return []


def check_editor_case(ts, logits, ge, yg, thr, NG):
    """The editor kernel against its plain version on CPU copies of the same
    inputs and the same probabilities: integer outputs bit-equal, floats
    within EDITOR_ATOL. Returns (plain outputs, float max abs err)."""
    prob = torch.sigmoid(logits)          # one tensor for both versions
    s_k, sw_k, ex_k = editor_fused.update_from_prob(ts, prob, ge, yg, thr, NG)
    torch.cuda.synchronize()
    s_p, sw_p, ex_p = editor_fused.update_from_prob(
        _to(ts, "cpu"), prob.cpu(), ge.cpu(), yg.cpu(), thr, NG)
    for f in ("E_pp", "E_pq", "mask_g", "mask_j", "append_ptr"):
        if not torch.equal(getattr(s_k, f).cpu(), getattr(s_p, f)):
            raise RuntimeError(f"editor: {f} differs from the plain version")
    if not (torch.equal(sw_k.cpu(), sw_p) and torch.equal(ex_k.cpu(), ex_p)):
        raise RuntimeError("editor: switching/extra differ from the plain "
                           "version")
    err = 0.0
    for f in ("xj", "y_joint"):
        d = (getattr(s_k, f).cpu() - getattr(s_p, f)).abs().max().item()
        if not d <= EDITOR_ATOL:
            raise RuntimeError(f"editor: {f} max abs err {d}")
        err = max(err, d)
    return (s_p, sw_p, ex_p), err


def phase_editor(reg, cls, state):
    dev = state.E_pp.device
    first = editor_inputs(reg, cls, state)
    cases = [("span1", first, C_THRESHOLD),
             ("forced_a", forced_editor_inputs(first[0], 0, 8, 2), 0.6),
             ("forced_b", forced_editor_inputs(first[0], 1, 24, 4), 0.6)]
    chain = forced_out_chain(first[0])
    if not chain:
        raise RuntimeError("editor: no forced-elimination chain found")
    cases += [(f"forced_out_{i}", tuple(
        a.to(dev) if isinstance(a, torch.Tensor) else _to(a, dev)
        for a in args), 0.6) for i, args in enumerate(chain)]
    NG = state.xg.shape[0]
    err = 0.0
    for name, (ts, logits, ge, yg), thr in cases:
        (s_p, sw_p, ex_p), e = check_editor_case(ts, logits, ge, yg, thr, NG)
        err = max(err, e)
        emit(phase="editor", case=name, ints_equal=True, max_abs_err=e,
             switches=int((sw_p[:, 0] >= 0).sum()),
             grains_deleted=int((ts.mask_g.cpu() != s_p.mask_g).sum()),
             extra=int((ex_p >= 0).sum()))
    if not int((ex_p >= 0).sum()):
        raise RuntimeError("editor: the forced elimination did not happen")
    ts, logits, ge, yg = first
    ms = cuda_ms(lambda: editor_fused.update_fused(ts, logits, ge, yg,
                                                   C_THRESHOLD, NG), n=20)
    ts_cpu = _to(ts, "cpu")
    t0 = time.perf_counter()
    editor_fused.update_fused(ts_cpu, logits.cpu(), ge.cpu(), yg.cpu(),
                              C_THRESHOLD, NG)
    plain_ms = (time.perf_counter() - t0) * 1e3
    # state read once and written once; the work is a dependent chain
    state_bytes = 4 * (2 * ts.E_pp.numel() + 2 * ts.E_pq.numel()
                       + 2 * ts.xj.numel() + 2 * ts.y_joint.numel()
                       + 2 * ts.mask_g.numel() + 2 * ts.mask_j.numel()
                       + logits.numel() + yg.shape[0] + ge.numel())
    bound_ms, bound_by = bound(0.0, state_bytes)
    emit(phase="editor_time", ms=ms, plain_cpu_ms=plain_ms,
         bound_ms=bound_ms, bound_by=bound_by)
    return dict(name="editor", route="cuda",
                source="graingraphnn_torch/csrc/editor.cu",
                replaces=REPLACES["editor"], max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=None,
                check=f"pass: integers bit-equal, floats atol {EDITOR_ATOL}, "
                      f"{len(cases)} cases")


def phase_rollout(reg, cls, state, n_spans):
    run = dr.make_rollout(reg, cls, n_steps=n_spans, c_threshold=C_THRESHOLD)
    run(state)                                   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    edge_stage.launches = 0
    edge_stage.shape_launches.clear()
    editor_fused.launches = 0
    t0 = time.perf_counter()
    final, aux = run(state)                      # the counted main-path run
    torch.cuda.synchronize()
    dts = [time.perf_counter() - t0]
    launches = {"edge_stage": edge_stage.launches,
                "edge_stage_by_shape": dict(edge_stage.shape_launches),
                "editor": editor_fused.launches}
    peak = torch.cuda.max_memory_allocated()
    for _ in range(3):
        t0 = time.perf_counter()
        run(state)
        torch.cuda.synchronize()
        dts.append(time.perf_counter() - t0)
    if launches["edge_stage"] != 12 * n_spans or launches["editor"] != n_spans:
        raise RuntimeError(f"launch counts {launches} for {n_spans} spans")
    for name, t in vars(final).items():
        if t.dtype.is_floating_point and not bool(torch.isfinite(t).all()):
            raise RuntimeError(f"rollout: non-finite {name}")
    edges = float(aux["message_edges"].sum())
    dt = min(dts)
    emit(phase="rollout", spans=n_spans, edges=edges, seconds=dts,
         edges_per_s=edges / dt, ms_per_span=dt / n_spans * 1e3,
         peak_mem_bytes=peak, launches={
             "edge_stage": launches["edge_stage"],
             "edge_stage_by_shape": {str(k): v for k, v in
                                     launches["edge_stage_by_shape"].items()},
             "editor": launches["editor"]},
         ring_overflow=int(aux["ring_overflow"].sum()),
         pp_overflow=int(aux["pp_overflow"].sum()),
         elim_saturated=int(aux["elim_saturated"].sum()),
         switches=int((aux["switching"][..., 0] >= 0).sum()),
         grain_events=int((aux["grain_events"] >= 0).sum()),
         live_grains=int(final.mask_g.sum()), live_joints=int(final.mask_j.sum()))
    return launches


def phase_profile(reg, cls, state, n_spans, top=14):
    """Device time by kernel over one rollout under torch.profiler, and the
    device's busy share of that run's wall time (profiler on)."""
    from torch.profiler import ProfilerActivity, profile

    run = dr.make_rollout(reg, cls, n_steps=n_spans, c_threshold=C_THRESHOLD)
    run(state)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = ev.self_cuda_time_total
        rows.append((ev.key, us / 1e3, ev.count))
    rows.sort(key=lambda r: -r[1])
    busy_ms = sum(r[1] for r in rows)
    emit(phase="profile", spans=n_spans, wall_ms=wall * 1e3,
         device_ms=busy_ms, device_busy_share=busy_ms / (wall * 1e3),
         kernels=len(rows), top=[{"name": k[:90], "ms": ms, "count": n}
                                 for k, ms, n in rows[:top]])


def phase_reference(reg, cls, state, reg_cpu, cls_cpu):
    """One span on the card against the same span through the plain
    versions on the CPU: forward outputs within tolerance, topology equal
    unless a switch probability lies within float noise of the threshold."""
    _, y_r, y_c, _ = dr.forward_stage(reg, cls, state, tj.RING_MAX)
    st_cpu = dr.DeviceRolloutState(**{k: v.cpu() for k, v in vars(state).items()})
    _, y_r0, y_c0, _ = dr.forward_stage(reg_cpu, cls_cpu, st_cpu, tj.RING_MAX)
    err = max((y_r[k].cpu() - y_r0[k]).abs().max().item() for k in y_r)
    err = max(err, (y_c["edge_event"].cpu() - y_c0["edge_event"]).abs().max().item())
    if not err <= 1e-3:
        raise RuntimeError(f"reference span: forward max abs err {err}")
    s1, _ = dr.device_step(reg, cls, state, c_threshold=C_THRESHOLD)
    s0, _ = dr.device_step(reg_cpu, cls_cpu, st_cpu, c_threshold=C_THRESHOLD)
    p = torch.sigmoid(y_c0["edge_event"])
    near = bool(((p - C_THRESHOLD).abs() < 1e-5).any())
    same = all(torch.equal(getattr(s1, f).cpu(), getattr(s0, f))
               for f in ("E_pp", "E_pq", "mask_g", "mask_j", "n_pp"))
    if not same and not near:
        raise RuntimeError("reference span: topology differs from the CPU span")
    pos = (s1.xj[:, :2].cpu() - s0.xj[:, :2]).abs().max().item()
    emit(phase="reference_span", forward_max_abs_err=err, topology_equal=same,
         threshold_adjacent=near, position_max_abs_err=pos)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="also profile one rollout by kernel")
    args = ap.parse_args()

    dev, _smi = phase_device()
    phase_build()
    cuda = torch.device("cuda")
    reg, _, _ = checkpoint.load_model("artifacts/40um/regressor0", cuda)
    cls, _, _ = checkpoint.load_model("artifacts/40um/classifier1", cuda)
    x, edges, mask, lxd, patch = dd.load_fixture()
    state, _, _ = dd.init_scaled_state(x, edges, mask, lxd, patch, device=cuda)

    conv_rows = phase_edge_stage(reg, state)
    editor_row = phase_editor(reg, cls, state)
    launches = phase_rollout(reg, cls, state, N_SPANS)
    if args.profile:
        phase_profile(reg, cls, state, N_SPANS)
    reg_cpu, _, _ = checkpoint.load_model("artifacts/40um/regressor0", "cpu")
    cls_cpu, _, _ = checkpoint.load_model("artifacts/40um/classifier1", "cpu")
    phase_reference(reg, cls, state, reg_cpu, cls_cpu)

    kernels = []
    for row in conv_rows.values():
        row = dict(row)
        row["launches"] = launches["edge_stage_by_shape"].get(
            row.pop("shape_key"), 0)
        kernels.append(row)
    kernels.append(dict(editor_row, launches=launches["editor"]))
    for k in kernels:
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms"):
            if not math.isfinite(k[key]):
                raise RuntimeError(f"{k['name']}: {key} = {k[key]}")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": dev}), flush=True)


if __name__ == "__main__":
    main()
