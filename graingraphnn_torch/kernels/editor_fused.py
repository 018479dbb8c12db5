"""Single-launch topology editor: `update_fused` runs the whole edit of one
span as ONE launch of the CUDA kernel in csrc/editor.cu (one thread block
per lane, state in device memory) for CUDA tensors, and the plain
sequential editor (kernels/editor_core.py) for CPU tensors. Both read the
same switch probabilities, computed here once, the same active windows
of the moving melt pool (state.active_j, active_g; all ones when not
given) and the same two-sided cleanup mask (cleanup_g_mask; every grain
when not given).

A state of one lane has fields [2, EP], [NJ, F], [NG], ... and an append
cursor []; a state of B independent lanes has the same fields with a
leading [B] axis, probabilities [B, EP], grain events [B, GE] and y_grain
[B, NG, 2], and is edited by one launch of B blocks. The budgets
max_switch and GE are per lane, at most MAX_MS and MAX_GE.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..rollout import topology_jit as tj
from . import _build
from . import editor_core as ec

launches = 0   # kernel launches since the caller last set it to 0

SOURCE = "editor"
NVCC_FLAGS = ("-fmad=false",)   # float decisions must match the plain version
MAX_MS = 64    # per-lane budgets the kernel takes (csrc/editor.cu)
MAX_GE = 16
_ARGTYPES = (
    [ctypes.c_int]                               # B lanes
    + [ctypes.c_void_p, ctypes.c_int] * 2        # pp, EP, pq, EQ
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]  # xj, NJ, xj row stride
    + [ctypes.c_void_p] * 3 + [ctypes.c_int]     # yj, mg, mj, NG
    + [ctypes.c_void_p] * 3 + [ctypes.c_int]     # prob, y_grain, ge, GE
    + [ctypes.c_void_p] * 3                      # aj, ag, cg
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int]   # threshold, num_grains, MS
    + [ctypes.c_void_p] * 4 + [ctypes.c_int]     # ptr, sw, extra, scratch, max_extra
    + [ctypes.c_void_p]                          # stream
)


def max_extra(n_grain_events: int, max_switch: int) -> int:
    return 2 * n_grain_events * (ec.RING + 1) + 2 * max_switch


def update_fused(
    state: tj.TopoState,
    edge_logits: torch.Tensor,   # [(B,) EP] float32, dead columns at -1e30
    grain_events: torch.Tensor,  # [(B,) GE] int32 grain ids, -1 pad
    y_grain: torch.Tensor,       # [(B,) NG, 2] regressor grain outputs
    threshold: float,
    num_grains: int,
    max_switch: int = tj.MAX_SWITCH,
    active_g: torch.Tensor | None = None,   # [(B,) NG] melt pool window
    cleanup_g_mask: torch.Tensor | None = None,   # [(B,) NG] bool
):
    """One span's topology edit of one lane or of B lanes. Returns (state,
    switching [(B,) max_switch, 2], extra [(B,) max_extra]) with -1 fills;
    the input state is not modified. state.active_j [(B,) NJ] and active_g
    [(B,) NG] are the melt pool's active windows (None: all active);
    cleanup_g_mask [(B,) NG] limits the two-sided cleanups to the grains
    it sets (None: every grain)."""
    prob = torch.sigmoid(edge_logits.float()).contiguous()
    return update_from_prob(state, prob, grain_events, y_grain, threshold,
                            num_grains, max_switch, active_g, cleanup_g_mask)


def update_from_prob(state, prob, grain_events, y_grain, threshold,
                     num_grains, max_switch=tj.MAX_SWITCH, active_g=None,
                     cleanup_g_mask=None):
    """update_fused given the switch probabilities [(B,) EP] themselves:
    the plain version for CPU tensors, the kernel for CUDA tensors."""
    if prob.device.type == "cpu":
        return _update_plain(state, prob, grain_events, y_grain, threshold,
                             num_grains, max_switch, active_g, cleanup_g_mask)
    return _update_cuda(state, prob, grain_events, y_grain, threshold,
                        num_grains, max_switch, active_g, cleanup_g_mask)


def windows(state: tj.TopoState, active_g=None):
    """The active windows (aj [(B,) NJ], ag [(B,) NG]) as contiguous int32
    on the state's device, all ones where not given."""
    def as_i32(w, like):
        if w is None:
            return torch.ones_like(like, dtype=torch.int32)
        return w.to(device=like.device, dtype=torch.int32).contiguous()
    return as_i32(state.active_j, state.mask_j), as_i32(active_g, state.mask_g)


def cleanup_mask(cleanup_g_mask, state: tj.TopoState):
    """The cleanup mask as contiguous int32 [(B,) NG] on the state's device,
    or None (every grain)."""
    if cleanup_g_mask is None:
        return None
    return cleanup_g_mask.to(device=state.mask_g.device,
                             dtype=torch.int32).contiguous()


def _clone(state: tj.TopoState) -> tj.TopoState:
    return tj.TopoState(
        E_pp=state.E_pp.to(torch.int32, copy=True).contiguous(),
        E_pq=state.E_pq.to(torch.int32, copy=True).contiguous(),
        xj=state.xj.to(torch.float32, copy=True).contiguous(),
        y_joint=state.y_joint.to(torch.float32, copy=True).contiguous(),
        mask_g=state.mask_g.to(torch.int32, copy=True).contiguous(),
        mask_j=state.mask_j.to(torch.int32, copy=True).contiguous(),
        append_ptr=state.append_ptr.to(torch.int32, copy=True).reshape(
            state.mask_g.shape[:-1]),
        active_j=state.active_j, q_ptr=state.q_ptr,
    )


def _update_plain(state, prob, grain_events, y_grain, threshold, num_grains,
                  max_switch, active_g, cleanup_g_mask=None):
    """editor_core on each lane in turn, in place on a copy of the state."""
    aj, ag = windows(state, active_g)
    cg = cleanup_mask(cleanup_g_mask, state)
    out = _clone(state)
    lanes = out.mask_g.shape[:-1]
    B = lanes.numel()
    ptr = out.append_ptr.reshape(B)
    E_pp, E_pq = out.E_pp.reshape(B, 2, -1), out.E_pq.reshape(B, 2, -1)
    xj, yj = out.xj.reshape(B, *out.xj.shape[-2:]), out.y_joint.reshape(
        B, -1, 2)
    mg, mj = out.mask_g.reshape(B, -1), out.mask_j.reshape(B, -1)
    aj, ag = aj.reshape(B, -1), ag.reshape(B, -1)
    cg = None if cg is None else cg.reshape(B, -1)
    prob = prob.reshape(B, -1)
    yg0 = y_grain[..., 0].float().reshape(B, -1)
    ge = grain_events.reshape(B, -1)
    switching, extra = [], []
    for b in range(B):
        st = ec.EditorState(
            pp0=E_pp[b, 0], pp1=E_pp[b, 1], pq0=E_pq[b, 0], pq1=E_pq[b, 1],
            posx=xj[b, :, 0], posy=xj[b, :, 1], gx=xj[b, :, 6],
            gy=xj[b, :, 7], yjx=yj[b, :, 0], yjy=yj[b, :, 1],
            mg=mg[b], mj=mj[b], ptr=int(ptr[b]),
        )
        sw0, sw1, ex = ec.editor_core(
            st, yg0[b], prob[b], ge[b].tolist(), np.float32(threshold),
            num_grains, max_switch, aj[b], ag[b],
            None if cg is None else cg[b])
        ptr[b] = st.ptr
        switching.append(torch.tensor([sw0, sw1], dtype=torch.int32).T)
        extra.append(torch.tensor(ex, dtype=torch.int32))
    return (out, torch.stack(switching).reshape(*lanes, max_switch, 2),
            torch.stack(extra).reshape(*lanes, -1))


def _update_cuda(state, prob, grain_events, y_grain, threshold, num_grains,
                 max_switch, active_g, cleanup_g_mask=None):
    global launches
    dev = prob.device
    for name, t in (("E_pp", state.E_pp), ("E_pq", state.E_pq),
                    ("xj", state.xj), ("y_joint", state.y_joint),
                    ("mask_g", state.mask_g), ("mask_j", state.mask_j),
                    ("grain_events", grain_events), ("y_grain", y_grain),
                    ("active_j", state.active_j), ("active_g", active_g),
                    ("cleanup_g_mask", cleanup_g_mask)):
        if t is not None and t.device != dev:
            raise ValueError(f"update_fused: {name} on {t.device}, prob on {dev}")
    lanes = tuple(state.mask_g.shape[:-1])
    NG, (NJ, F) = state.mask_g.shape[-1], state.xj.shape[-2:]
    EP = state.E_pp.shape[-1]
    if F < 8:
        raise ValueError("update_fused: xj needs columns 0:2 and 6:8")
    if (len(lanes) > 1 or state.E_pp.shape[:-1] != (*lanes, 2)
            or state.E_pq.shape[:-1] != (*lanes, 2)
            or state.xj.shape[:-2] != lanes
            or prob.shape != (*lanes, EP) or prob.dtype != torch.float32
            or not prob.is_contiguous()
            or state.y_joint.shape != (*lanes, NJ, 2)
            or state.mask_j.shape != (*lanes, NJ)
            or state.append_ptr.numel() != torch.Size(lanes).numel()
            or y_grain.shape[:-1] != (*lanes, NG)
            or (state.active_j is not None
                and state.active_j.shape != (*lanes, NJ))
            or (active_g is not None and active_g.shape != (*lanes, NG))
            or (cleanup_g_mask is not None
                and cleanup_g_mask.shape != (*lanes, NG))
            or grain_events.shape[:-1] != lanes
            or not 0 < num_grains <= NG):
        raise ValueError("update_fused: state, probabilities and grain "
                         "arrays do not fit together")
    GE = grain_events.shape[-1]
    if max_switch > MAX_MS or GE > MAX_GE:
        raise ValueError(
            f"update_fused: the kernel takes at most {MAX_MS} switches and "
            f"{MAX_GE} grain events a lane, not {max_switch} and {GE}; run "
            "B lanes stacked (one block each), not packed into one graph")
    fn = _build.function(SOURCE, "editor_update", _ARGTYPES, NVCC_FLAGS)
    out = launch(fn, torch.cuda.current_stream(dev).cuda_stream, state, prob,
                 grain_events, y_grain, threshold, num_grains, max_switch,
                 active_g, cleanup_g_mask)
    launches += 1
    return out


def launch(fn, stream, state, prob, grain_events, y_grain, threshold,
           num_grains, max_switch, active_g=None, cleanup_g_mask=None):
    """Copy the state, allocate the outputs beside it and call the C entry
    `fn` (the built kernel; tests pass a CPU build of the same source) on
    checked inputs of one lane or B lanes, with the active windows of
    state.active_j and active_g (all ones where not given) and the cleanup
    mask (a null pointer where not given). Returns (state, switching,
    extra)."""
    dev = prob.device
    aj, ag = windows(state, active_g)
    cg = cleanup_mask(cleanup_g_mask, state)
    out = _clone(state)
    lanes = out.mask_g.shape[:-1]
    B = lanes.numel()
    ge = grain_events.to(torch.int32).contiguous()
    yg0 = y_grain[..., 0].float().contiguous()
    (NJ, F), NG = out.xj.shape[-2:], out.mask_g.shape[-1]
    EP, EQ = out.E_pp.shape[-1], out.E_pq.shape[-1]
    GE = ge.shape[-1]
    MX = max_extra(GE, max_switch)
    switching = torch.empty((*lanes, max_switch, 2), dtype=torch.int32,
                            device=dev)
    extra = torch.empty((*lanes, MX), dtype=torch.int32, device=dev)
    scratch = torch.empty(B * (num_grains + 2 * EP + NJ + 1 + EQ),
                          dtype=torch.int32, device=dev)
    fn(
        B, out.E_pp.data_ptr(), EP, out.E_pq.data_ptr(), EQ,
        out.xj.data_ptr(), NJ, F,
        out.y_joint.data_ptr(), out.mask_g.data_ptr(), out.mask_j.data_ptr(),
        NG, prob.data_ptr(), yg0.data_ptr(), ge.data_ptr(), GE,
        aj.data_ptr(), ag.data_ptr(), None if cg is None else cg.data_ptr(),
        float(np.float32(threshold)), num_grains, max_switch,
        out.append_ptr.data_ptr(), switching.data_ptr(), extra.data_ptr(),
        scratch.data_ptr(), MX, stream,
    )
    return out, switching, extra
