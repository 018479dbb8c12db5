"""Single-launch topology editor: `update_fused` runs the whole edit of one
span as ONE launch of the CUDA kernel in csrc/editor.cu (one thread block,
state in device memory) for CUDA tensors, and the plain sequential editor
(kernels/editor_core.py) for CPU tensors. Both read the same switch
probabilities, computed here once, and the same active windows of the
moving melt pool (state.active_j, active_g; all ones when not given).
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
_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_int] * 2          # pp, EP, pq, EQ
    + [ctypes.c_void_p, ctypes.c_int, ctypes.c_int]  # xj, NJ, xj row stride
    + [ctypes.c_void_p] * 3 + [ctypes.c_int]     # yj, mg, mj, NG
    + [ctypes.c_void_p] * 3 + [ctypes.c_int]     # prob, y_grain, ge, GE
    + [ctypes.c_void_p] * 2                      # aj, ag
    + [ctypes.c_float, ctypes.c_int, ctypes.c_int]   # threshold, num_grains, MS
    + [ctypes.c_void_p] * 4 + [ctypes.c_int]     # ptr, sw, extra, scratch, max_extra
    + [ctypes.c_void_p]                          # stream
)


def max_extra(n_grain_events: int, max_switch: int) -> int:
    return 2 * n_grain_events * (ec.RING + 1) + 2 * max_switch


def update_fused(
    state: tj.TopoState,
    edge_logits: torch.Tensor,   # [EP] float32, dead columns at -1e30
    grain_events: torch.Tensor,  # [GE] int32 grain ids, -1 pad
    y_grain: torch.Tensor,       # [NG, 2] regressor grain outputs
    threshold: float,
    num_grains: int,
    max_switch: int = tj.MAX_SWITCH,
    active_g: torch.Tensor | None = None,   # [NG] melt pool grain window
):
    """One span's topology edit. Returns (state, switching [max_switch, 2],
    extra [max_extra]) with -1 fills; the input state is not modified.
    state.active_j [NJ] and active_g [NG] are the melt pool's active
    windows (None: all active)."""
    prob = torch.sigmoid(edge_logits.float()).contiguous()
    return update_from_prob(state, prob, grain_events, y_grain, threshold,
                            num_grains, max_switch, active_g)


def update_from_prob(state, prob, grain_events, y_grain, threshold,
                     num_grains, max_switch=tj.MAX_SWITCH, active_g=None):
    """update_fused given the switch probabilities [EP] themselves: the
    plain version for CPU tensors, the kernel for CUDA tensors."""
    if prob.device.type == "cpu":
        return _update_plain(state, prob, grain_events, y_grain, threshold,
                             num_grains, max_switch, active_g)
    return _update_cuda(state, prob, grain_events, y_grain, threshold,
                        num_grains, max_switch, active_g)


def windows(state: tj.TopoState, active_g=None):
    """The active windows (aj [NJ], ag [NG]) as contiguous int32 on the
    state's device, all ones where not given."""
    def as_i32(w, like):
        if w is None:
            return torch.ones_like(like, dtype=torch.int32)
        return w.to(device=like.device, dtype=torch.int32).contiguous()
    return as_i32(state.active_j, state.mask_j), as_i32(active_g, state.mask_g)


def _clone(state: tj.TopoState) -> tj.TopoState:
    return tj.TopoState(
        E_pp=state.E_pp.to(torch.int32, copy=True).contiguous(),
        E_pq=state.E_pq.to(torch.int32, copy=True).contiguous(),
        xj=state.xj.to(torch.float32, copy=True).contiguous(),
        y_joint=state.y_joint.to(torch.float32, copy=True).contiguous(),
        mask_g=state.mask_g.to(torch.int32, copy=True).contiguous(),
        mask_j=state.mask_j.to(torch.int32, copy=True).contiguous(),
        append_ptr=state.append_ptr.to(torch.int32, copy=True).reshape(()),
        active_j=state.active_j, q_ptr=state.q_ptr,
    )


def _update_plain(state, prob, grain_events, y_grain, threshold, num_grains,
                  max_switch, active_g):
    aj, ag = windows(state, active_g)
    out = _clone(state)
    st = ec.EditorState(
        pp0=out.E_pp[0], pp1=out.E_pp[1], pq0=out.E_pq[0], pq1=out.E_pq[1],
        posx=out.xj[:, 0], posy=out.xj[:, 1], gx=out.xj[:, 6],
        gy=out.xj[:, 7], yjx=out.y_joint[:, 0], yjy=out.y_joint[:, 1],
        mg=out.mask_g, mj=out.mask_j, ptr=int(out.append_ptr),
    )
    sw0, sw1, extra = ec.editor_core(
        st, y_grain[:, 0].float(), prob, grain_events.tolist(),
        np.float32(threshold), num_grains, max_switch, aj, ag)
    out.append_ptr.fill_(st.ptr)
    switching = torch.tensor([sw0, sw1], dtype=torch.int32).T.contiguous()
    return out, switching, torch.tensor(extra, dtype=torch.int32)


def _update_cuda(state, prob, grain_events, y_grain, threshold, num_grains,
                 max_switch, active_g):
    global launches
    dev = prob.device
    for name, t in (("E_pp", state.E_pp), ("E_pq", state.E_pq),
                    ("xj", state.xj), ("y_joint", state.y_joint),
                    ("mask_g", state.mask_g), ("mask_j", state.mask_j),
                    ("grain_events", grain_events), ("y_grain", y_grain),
                    ("active_j", state.active_j), ("active_g", active_g)):
        if t is not None and t.device != dev:
            raise ValueError(f"update_fused: {name} on {t.device}, prob on {dev}")
    NJ, F = state.xj.shape
    NG, EP = state.mask_g.shape[0], state.E_pp.shape[1]
    if F < 8:
        raise ValueError("update_fused: xj needs columns 0:2 and 6:8")
    if (state.E_pp.shape[0] != 2 or state.E_pq.shape[0] != 2
            or prob.shape != (EP,) or prob.dtype != torch.float32
            or not prob.is_contiguous() or state.y_joint.shape != (NJ, 2)
            or state.mask_j.shape != (NJ,) or y_grain.shape[0] != NG
            or (state.active_j is not None
                and state.active_j.shape != (NJ,))
            or (active_g is not None and active_g.shape != (NG,))
            or grain_events.dim() != 1 or not 0 < num_grains <= NG):
        raise ValueError("update_fused: state, probabilities and grain "
                         "arrays do not fit together")
    fn = _build.function(SOURCE, "editor_update", _ARGTYPES, NVCC_FLAGS)
    out = launch(fn, torch.cuda.current_stream(dev).cuda_stream, state, prob,
                 grain_events, y_grain, threshold, num_grains, max_switch,
                 active_g)
    launches += 1
    return out


def launch(fn, stream, state, prob, grain_events, y_grain, threshold,
           num_grains, max_switch, active_g=None):
    """Copy the state, allocate the outputs beside it and call the C entry
    `fn` (the built kernel; tests pass a CPU build of the same source) on
    checked inputs, with the active windows of state.active_j and active_g
    (all ones where not given). Returns (state, switching, extra)."""
    dev = prob.device
    aj, ag = windows(state, active_g)
    out = _clone(state)
    ge = grain_events.to(torch.int32).contiguous()
    yg0 = y_grain[:, 0].float().contiguous()
    (NJ, F), NG = out.xj.shape, out.mask_g.shape[0]
    EP, EQ = out.E_pp.shape[1], out.E_pq.shape[1]
    MX = max_extra(ge.shape[0], max_switch)
    switching = torch.empty((max_switch, 2), dtype=torch.int32, device=dev)
    extra = torch.empty(MX, dtype=torch.int32, device=dev)
    scratch = torch.empty(num_grains + 2 * EP + NJ + 1 + EQ,
                          dtype=torch.int32, device=dev)
    fn(
        out.E_pp.data_ptr(), EP, out.E_pq.data_ptr(), EQ,
        out.xj.data_ptr(), NJ, F,
        out.y_joint.data_ptr(), out.mask_g.data_ptr(), out.mask_j.data_ptr(),
        NG, prob.data_ptr(), yg0.data_ptr(), ge.data_ptr(), ge.shape[0],
        aj.data_ptr(), ag.data_ptr(),
        float(np.float32(threshold)), num_grains, max_switch,
        out.append_ptr.data_ptr(), switching.data_ptr(), extra.data_ptr(),
        scratch.data_ptr(), MX, stream,
    )
    return out, switching, extra
