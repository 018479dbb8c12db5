"""The fused PeriodConv edge stage as CUDA kernels (csrc/edge_stage.cu):
`apply_period_conv_cuda` is what ops.period_conv.apply_period_conv runs
for CUDA tensors when its caller asks for the kernels (forwards without
autograd: the kernels have no backward, and the wrappers raise when grad
mode is on and an input requires grad), one grouped `node_proj` launch (the four node
projections, 3xTF32 tensor cores) then one `edge_attn` launch (a block
per tile of destination rows and gate, the l2 product once per row on
3xTF32 tensor cores). Its plain version is
ops.period_conv.apply_period_conv_plain. `node_proj_cuda` and
`edge_attn_cuda` launch each kernel alone (plain versions:
period_conv.node_projections_plain and period_conv.edge_attn_plain).

precision="bf16" takes the bf16 kernels of csrc/edge_stage_bf16.cu
instead (`node_proj_bf16`, `edge_attn_bf16`: bf16 operands on tensor cores,
fp32 accumulation, rounded where the TPU kernel rounds), whose plain
versions are the same functions at precision="bf16". They take the same
fp32 inputs and weights and round them to bf16 as they load them, so no
bf16 copy is made or cached.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# kernel launches since the caller last called reset_counts(): by kernel,
# fp32 (launches) and bf16 (bf16_launches); by (kernel, F_src, F_dst), the
# bf16 kernels named node_proj_bf16 and edge_attn_bf16; and, for the fp32
# edge_attn, by its ring width K
launches = {"node_proj": 0, "edge_attn": 0}
bf16_launches = {"node_proj": 0, "edge_attn": 0}
shape_launches: dict = {}
ring_launches: dict = {}

SOURCE = "edge_stage"
SOURCE_BF16 = "edge_stage_bf16"
NVCC_FLAGS: tuple = ()
# each precision's source and its C entries
ENTRIES = {
    "fp32": (SOURCE, {"conv": "edge_stage_forward",
                      "node_proj": "edge_node_proj",
                      "edge_attn": "edge_attn_forward"}),
    "bf16": (SOURCE_BF16, {"conv": "edge_stage_bf16_forward",
                           "node_proj": "edge_node_proj_bf16",
                           "edge_attn": "edge_attn_bf16_forward"}),
}
MAX_F, MAX_G, MAX_C, MAX_K = 128, 8, 128, 64    # limits of csrc/edge_stage.cu
_P, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = (
    [_P, _I, _I] * 2                   # x_src, x_dst
    + [_P] * 3 + [_I]                  # nbr, len, mask, K
    + [_P] * 11 + [_I] * 2             # weights, G, C
    + [_P] * 6                         # scratch, out, stream
)
_PROJ_ARGTYPES = [_P, _I, _I] * 2 + [_P] * 8 + [_I] + [_P] * 5
_ATTN_ARGTYPES = ([_P, _I, _I] * 2 + [_P] * 3 + [_I] + [_P] * 9 + [_I] * 2
                  + [_P] * 2)


def reset_counts():
    for counts in (launches, bf16_launches):
        for k in counts:
            counts[k] = 0
    shape_launches.clear()
    ring_launches.clear()


def _count(kernel, Fs, Fd, precision, K=None):
    bf16 = precision == "bf16"
    (bf16_launches if bf16 else launches)[kernel] += 1
    key = (kernel + "_bf16" if bf16 else kernel, Fs, Fd)
    shape_launches[key] = shape_launches.get(key, 0) + 1
    if K is not None and not bf16:
        ring_launches[K] = ring_launches.get(K, 0) + 1


def _entry(precision, which):
    """The bound C entry `which` ("conv", "node_proj" or "edge_attn") of
    the precision's source."""
    if precision not in ENTRIES:
        raise ValueError(f"precision {precision!r}: one of {tuple(ENTRIES)}")
    source, symbols = ENTRIES[precision]
    argtypes = {"conv": _ARGTYPES, "node_proj": _PROJ_ARGTYPES,
                "edge_attn": _ATTN_ARGTYPES}[which]
    return _build.function(source, symbols[which], argtypes, NVCC_FLAGS)


def _check(x_src, tensors):
    # the kernels have no backward: their outputs would carry no grad_fn and
    # the weights would silently get no gradient
    if torch.is_grad_enabled():
        grad = [n for n, (t, _) in tensors.items() if t.requires_grad]
        if grad:
            raise RuntimeError(
                f"edge stage kernels have no backward, and {', '.join(grad)} "
                "require grad: call them under torch.no_grad() or take the "
                "torch formulation (apply_period_conv(..., kernels=False))")
    for name, (t, shape) in tensors.items():
        want = torch.int32 if name == "nbr" else torch.float32
        if t.device.type != "cuda" or t.device != x_src.device:
            raise ValueError(f"edge stage: {name} on {t.device}, "
                             f"x_src on {x_src.device}")
        if t.dtype != want or not t.is_contiguous() or t.shape != shape:
            raise ValueError(f"edge stage: {name} must be contiguous {want} "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")


def _limits(Fs, Fd, G=1, C=1, K=1):
    if not (3 <= Fs <= MAX_F and 3 <= Fd <= MAX_F and 1 <= G <= MAX_G
            and 1 <= C <= MAX_C and 1 <= K <= MAX_K):
        raise ValueError(f"edge stage takes F<={MAX_F}, G<={MAX_G}, "
                         f"C<={MAX_C}, K<={MAX_K}: got F={Fs},{Fd} G={G} "
                         f"C={C} K={K}")


def _proj_tensors(conv, x_src, x_dst, GC):
    (Ns, Fs), (Nd, Fd) = x_src.shape, x_dst.shape
    return {
        "x_src": (x_src, (Ns, Fs)), "x_dst": (x_dst, (Nd, Fd)),
        "query.w": (conv.query.w, (Fd, GC)), "query.b": (conv.query.b, (GC,)),
        "key.w": (conv.key.w, (Fs, GC)), "key.b": (conv.key.b, (GC,)),
        "value.w": (conv.value.w, (Fs, GC)), "value.b": (conv.value.b, (GC,)),
        "skip.w": (conv.skip.w, (Fd, GC)), "skip.b": (conv.skip.b, (GC,)),
    }


def _attn_tensors(conv, x_src, x_dst, nbr, edge_len, nbr_mask, G, C):
    Nd, K = x_dst.shape[0], nbr.shape[1]
    return {
        "nbr": (nbr, (Nd, K)), "edge_len": (edge_len, (Nd, K)),
        "nbr_mask": (nbr_mask, (Nd, K)),
        "l2.w": (conv.l2.w, (G, C, C)), "l2.b": (conv.l2.b, (G, C)),
        "edge.w": (conv.edge.w, (G * C,)),
    }


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def apply_period_conv_cuda(conv, x_src, x_dst, nbr, edge_len, nbr_mask, *,
                           num_gates: int, out_channels: int,
                           precision: str = "fp32"):
    """Fused-gate periodic conv on the card, fp32 or bf16. Returns
    [Nd, G*C] fp32."""
    G, C = num_gates, out_channels
    (Ns, Fs), (Nd, Fd), K = x_src.shape, x_dst.shape, nbr.shape[1]
    _check(x_src, {**_proj_tensors(conv, x_src, x_dst, G * C),
                   **_attn_tensors(conv, x_src, x_dst, nbr, edge_len,
                                   nbr_mask, G, C)})
    _limits(Fs, Fd, G, C, K)
    out = launch(_entry(precision, "conv"), _stream(x_src), conv, x_src,
                 x_dst, nbr, edge_len, nbr_mask, G, C)
    if Ns + Nd > 0:
        _count("node_proj", Fs, Fd, precision)
    if Nd > 0:
        _count("edge_attn", Fs, Fd, precision, K)
    return out


def node_proj_cuda(conv, x_src, x_dst, precision: str = "fp32"):
    """The node projections alone, one node_proj launch. Returns
    (K [Ns, GC], V [Ns, GC], Q [Nd, GC], skip [Nd, GC]); at bf16, K and V
    leave out the position lanes (period_conv.node_projections_plain)."""
    GC = conv.key.w.shape[1]
    (Ns, Fs), (Nd, Fd) = x_src.shape, x_dst.shape
    _check(x_src, _proj_tensors(conv, x_src, x_dst, GC))
    _limits(Fs, Fd)
    out = launch_node_proj(_entry(precision, "node_proj"), _stream(x_src),
                           conv, x_src, x_dst)
    if Ns + Nd > 0:
        _count("node_proj", Fs, Fd, precision)
    return out


def edge_attn_cuda(conv, x_src, x_dst, nbr, edge_len, nbr_mask, proj, *,
                   num_gates: int, out_channels: int, precision: str = "fp32"):
    """The edge kernel alone, one edge_attn launch, on the node projections
    `proj` = (K, V, Q, skip) of the same precision. Returns [Nd, G*C]."""
    G, C = num_gates, out_channels
    (Ns, Fs), (Nd, Fd), K = x_src.shape, x_dst.shape, nbr.shape[1]
    names = ("kn", "vn", "q", "sk")
    _check(x_src, {
        "x_src": (x_src, (Ns, Fs)), "x_dst": (x_dst, (Nd, Fd)),
        "key.w": (conv.key.w, (Fs, G * C)),
        "value.w": (conv.value.w, (Fs, G * C)),
        **_attn_tensors(conv, x_src, x_dst, nbr, edge_len, nbr_mask, G, C),
        **{n: (t, (Ns if i < 2 else Nd, G * C))
           for i, (n, t) in enumerate(zip(names, proj))}})
    _limits(Fs, Fd, G, C, K)
    out = launch_edge_attn(_entry(precision, "edge_attn"), _stream(x_src),
                           conv, x_src, x_dst, nbr, edge_len, nbr_mask, proj,
                           G, C)
    if Nd > 0:
        _count("edge_attn", Fs, Fd, precision, K)
    return out


def _empty(n, GC, like):
    return torch.empty((n, GC), dtype=torch.float32, device=like.device)


def _proj_args(conv, x_src, x_dst):
    (Ns, Fs), (Nd, Fd) = x_src.shape, x_dst.shape
    return [x_src.data_ptr(), Ns, Fs, x_dst.data_ptr(), Nd, Fd,
            conv.query.w.data_ptr(), conv.query.b.data_ptr(),
            conv.key.w.data_ptr(), conv.key.b.data_ptr(),
            conv.value.w.data_ptr(), conv.value.b.data_ptr(),
            conv.skip.w.data_ptr(), conv.skip.b.data_ptr()]


def launch(fn, stream, conv, x_src, x_dst, nbr, edge_len, nbr_mask, G, C):
    """Allocate the output and scratch beside x_src and call the C entry
    `fn` of the fused conv (the built kernel; tests pass a CPU build of the
    same source) on checked inputs."""
    (Ns, Fs), (Nd, Fd), K = x_src.shape, x_dst.shape, nbr.shape[1]
    GC = G * C
    kn, vn = _empty(Ns, GC, x_src), _empty(Ns, GC, x_src)
    q, sk, out = _empty(Nd, GC, x_src), _empty(Nd, GC, x_src), _empty(Nd, GC, x_src)
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


def launch_node_proj(fn, stream, conv, x_src, x_dst):
    """Call the C entry `fn` of node_proj; returns (K, V, Q, skip)."""
    GC = conv.key.w.shape[1]
    Ns, Nd = x_src.shape[0], x_dst.shape[0]
    outs = (_empty(Ns, GC, x_src), _empty(Ns, GC, x_src),
            _empty(Nd, GC, x_src), _empty(Nd, GC, x_src))
    fn(*_proj_args(conv, x_src, x_dst), GC,
       *[t.data_ptr() for t in outs], stream)
    return outs


def launch_edge_attn(fn, stream, conv, x_src, x_dst, nbr, edge_len, nbr_mask,
                     proj, G, C):
    """Call the C entry `fn` of edge_attn on the projections `proj`."""
    (Ns, Fs), (Nd, Fd), K = x_src.shape, x_dst.shape, nbr.shape[1]
    out = _empty(Nd, G * C, x_src)
    fn(x_src.data_ptr(), Ns, Fs, x_dst.data_ptr(), Nd, Fd,
       nbr.data_ptr(), edge_len.data_ptr(), nbr_mask.data_ptr(), K,
       *[t.data_ptr() for t in proj],
       conv.key.w.data_ptr(), conv.value.w.data_ptr(),
       conv.l2.w.data_ptr(), conv.l2.b.data_ptr(), conv.edge.w.data_ptr(),
       G, C, out.data_ptr(), stream)
    return out
