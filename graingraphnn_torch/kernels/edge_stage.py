"""The fused PeriodConv edge stage as a CUDA kernel (csrc/edge_stage.cu):
`apply_period_conv_cuda` is what ops.period_conv.apply_period_conv runs
for CUDA tensors. Its plain version is ops.period_conv.apply_period_conv_plain.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0   # kernel launches since the caller last set it to 0
shape_launches: dict = {}   # the same launches by (K, F_src, F_dst)

SOURCE = "edge_stage"
NVCC_FLAGS: tuple = ()
MAX_F, MAX_GC, MAX_G, MAX_K = 128, 512, 8, 16   # limits of csrc/edge_stage.cu
_ARGTYPES = (
    [ctypes.c_void_p, ctypes.c_int, ctypes.c_int] * 2   # x_src, x_dst
    + [ctypes.c_void_p] * 3 + [ctypes.c_int]            # nbr, len, mask, K
    + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 2       # weights, G, C
    + [ctypes.c_void_p] * 6                             # scratch, out, stream
)


def apply_period_conv_cuda(conv, x_src, x_dst, nbr, edge_len, nbr_mask, *,
                           num_gates: int, out_channels: int):
    """Fused-gate periodic conv on the card, fp32. Returns [Nd, G*C]."""
    global launches
    G, C = num_gates, out_channels
    GC = G * C
    (Ns, Fs), (Nd, Fd), K = x_src.shape, x_dst.shape, nbr.shape[1]
    tensors = {
        "x_src": (x_src, (Ns, Fs)), "x_dst": (x_dst, (Nd, Fd)),
        "nbr": (nbr, (Nd, K)), "edge_len": (edge_len, (Nd, K)),
        "nbr_mask": (nbr_mask, (Nd, K)),
        "query.w": (conv.query.w, (Fd, GC)), "query.b": (conv.query.b, (GC,)),
        "key.w": (conv.key.w, (Fs, GC)), "key.b": (conv.key.b, (GC,)),
        "value.w": (conv.value.w, (Fs, GC)), "value.b": (conv.value.b, (GC,)),
        "skip.w": (conv.skip.w, (Fd, GC)), "skip.b": (conv.skip.b, (GC,)),
        "l2.w": (conv.l2.w, (G, C, C)), "l2.b": (conv.l2.b, (G, C)),
        "edge.w": (conv.edge.w, (GC,)),
    }
    for name, (t, shape) in tensors.items():
        want = torch.int32 if name == "nbr" else torch.float32
        if t.device.type != "cuda" or t.device != x_src.device:
            raise ValueError(f"edge stage: {name} on {t.device}, "
                             f"x_src on {x_src.device}")
        if t.dtype != want or not t.is_contiguous() or t.shape != shape:
            raise ValueError(f"edge stage: {name} must be contiguous {want} "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
    if not (3 <= Fs <= MAX_F and 3 <= Fd <= MAX_F and GC <= MAX_GC
            and G <= MAX_G and 1 <= K <= MAX_K):
        raise ValueError(f"edge stage takes F<={MAX_F}, G*C<={MAX_GC}, "
                         f"K<={MAX_K}: got F={Fs},{Fd} G={G} C={C} K={K}")
    fn = _build.function(SOURCE, "edge_stage_forward", _ARGTYPES, NVCC_FLAGS)
    out = launch(fn, torch.cuda.current_stream(x_src.device).cuda_stream,
                 conv, x_src, x_dst, nbr, edge_len, nbr_mask, G, C)
    launches += 1
    shape_launches[(K, Fs, Fd)] = shape_launches.get((K, Fs, Fd), 0) + 1
    return out


def launch(fn, stream, conv, x_src, x_dst, nbr, edge_len, nbr_mask, G, C):
    """Allocate the output and scratch beside x_src and call the C entry
    `fn` (the built kernel; tests pass a CPU build of the same source) on
    checked inputs."""
    (Ns, Fs), (Nd, Fd), K = x_src.shape, x_dst.shape, nbr.shape[1]
    empty = lambda n: torch.empty((n, G * C), dtype=torch.float32,  # noqa: E731
                                  device=x_src.device)
    kn, vn, q, sk, out = empty(Ns), empty(Ns), empty(Nd), empty(Nd), empty(Nd)
    fn(
        x_src.data_ptr(), Ns, Fs, x_dst.data_ptr(), Nd, Fd,
        nbr.data_ptr(), edge_len.data_ptr(), nbr_mask.data_ptr(), K,
        conv.query.w.data_ptr(), conv.query.b.data_ptr(),
        conv.key.w.data_ptr(), conv.key.b.data_ptr(),
        conv.value.w.data_ptr(), conv.value.b.data_ptr(),
        conv.skip.w.data_ptr(), conv.skip.b.data_ptr(),
        conv.l2.w.data_ptr(), conv.l2.b.data_ptr(), conv.edge.w.data_ptr(),
        G, C, kn.data_ptr(), vn.data_ptr(), q.data_ptr(), sk.data_ptr(),
        out.data_ptr(), stream,
    )
    return out
