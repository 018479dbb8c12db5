"""The fused PeriodConv edge stage as CUDA kernels (csrc/edge_stage.cu):
`apply_period_conv_cuda` is what ops.period_conv.apply_period_conv runs
for CUDA tensors when its caller asks for the kernels (forwards without
autograd: the kernels have no backward, and the wrappers raise when grad
mode is on and an input requires grad), one grouped `node_proj` launch (the four node
projections on wgmma in 3xTF32, the weights as `pack_tf32x3` splits and
lays them out, built once per weight version and cached per conv like
`pack_bf16` below) then one `edge_attn` launch (persistent blocks that walk
tiles of destination rows for a group of gates, the l2 product once per
row on 3xTF32 tensor cores, Wl2 as `pack_l2` orders it). Its plain
version is
ops.period_conv.apply_period_conv_plain. `node_proj_cuda` and
`edge_attn_cuda` launch each kernel alone (plain versions:
period_conv.node_projections_plain and period_conv.edge_attn_plain).

precision="bf16" takes the bf16 kernels of csrc/edge_stage_bf16.cu
instead (`node_proj_bf16`, `edge_attn_bf16`: bf16 operands on tensor cores,
fp32 accumulation, rounded where the TPU kernel rounds), whose plain
versions are the same functions at precision="bf16". They take the fp32
inputs and round them as they load them, and the conv's weights as
`pack_bf16` lays them out: bf16, in the operand layouts of the kernels'
products, built once per weight version and cached per conv (rebuilt
when a weight's storage or version changes, as after an optimizer's
in-place step; never used stale), so that each block brings its weight
slice in with one bulk copy. Both kernels are bound by bytes (the fp32
outputs; the gathered projections) and, at the rollout's sizes, by the
latency of their dependent loads: the source note of
csrc/edge_stage_bf16.cu says what each design does about it. x_src and
x_dst and the projections' biases must be 16-byte aligned at bf16 (the
bulk copies' rule; a tensor torch allocates is).
"""

from __future__ import annotations

import ctypes
import weakref

import torch

from . import _build

# kernel launches since the caller last called reset_counts(): by kernel,
# fp32 (launches) and bf16 (bf16_launches); by (kernel, F_src, F_dst), the
# bf16 kernels named node_proj_bf16 and edge_attn_bf16; for the fp32
# edge_attn, by its ring width K; and the fp32 node_proj's and edge_attn's
# launches by the grid their launchers chose (csrc/edge_stage.cu np_plan,
# ea_plan: one wave, or persistent blocks), counted by launch,
# launch_node_proj and launch_edge_attn, whatever build of the source they
# call
launches = {"node_proj": 0, "edge_attn": 0}
bf16_launches = {"node_proj": 0, "edge_attn": 0}
shape_launches: dict = {}
ring_launches: dict = {}
node_proj_branches = {"one_wave": 0, "persistent": 0}
edge_attn_branches = {"one_wave": 0, "persistent": 0}
BRANCHES = tuple(node_proj_branches)      # the C entries' branch codes 0, 1

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
# the fp32 entries: the TF32 pack in place of the projections' weight
# matrices (wk and wv still go in whole: edge_attn reads their position
# rows), and last the addresses of ints that get node_proj's and
# edge_attn's branches
_ARGTYPES = (
    [_P, _I, _I] * 2                   # x_src, x_dst
    + [_P] * 3 + [_I]                  # nbr, len, mask, K
    + [_P] * 10 + [_I] * 2             # pack, biases, wk, wv, l2, We, G, C
    + [_P] * 6                         # scratch, out, stream
    + [_P] * 2                         # branches
)
_PROJ_ARGTYPES = [_P, _I, _I] * 2 + [_P] * 5 + [_I] + [_P] * 5 + [_P]
_ATTN_ARGTYPES = ([_P, _I, _I] * 2 + [_P] * 3 + [_I] + [_P] * 9 + [_I] * 2
                  + [_P] * 3)
# the bf16 entries: the pack in place of the fp32 weight matrices (the
# biases, We and the position rows of Wk and Wv stay fp32)
_BF16_ARGTYPES = ([_P, _I, _I] * 2 + [_P] * 3 + [_I] + [_P] * 9 + [_I] * 2
                  + [_P] * 6)
_BF16_PROJ_ARGTYPES = [_P, _I, _I] * 2 + [_P] * 5 + [_I] + [_P] * 5
# the fp32 list less the branch: the pack takes wk's place
_BF16_ATTN_ARGTYPES = _ATTN_ARGTYPES[:-1]
ARGTYPES = {
    "fp32": {"conv": _ARGTYPES, "node_proj": _PROJ_ARGTYPES,
             "edge_attn": _ATTN_ARGTYPES},
    "bf16": {"conv": _BF16_ARGTYPES, "node_proj": _BF16_PROJ_ARGTYPES,
             "edge_attn": _BF16_ATTN_ARGTYPES},
}
PACK_COLS = 128          # the projections' column slice (NB_BN, NP_BN)
_packs: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_packs_tf32x3: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_packs_l2: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def reset_counts():
    for counts in (launches, bf16_launches, node_proj_branches,
                   edge_attn_branches):
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
    return _build.function(source, symbols[which], ARGTYPES[precision][which],
                           NVCC_FLAGS)


def _pad16(n):
    return (n + 15) // 16 * 16


def _words(w, depth, cols):
    """w [k, n] as int32 words [cols, depth // 2 + 4]: word (n, j) holds
    bf16(w[2j, n]) in its low half and bf16(w[2j + 1, n]) in its high half
    (a k pair of one column, as an m16n8k16 B fragment takes it); zero past
    w and in the last 4 words of a column (padding that keeps fragment
    loads conflict-free)."""
    b = torch.zeros((cols, depth + 8), dtype=torch.bfloat16, device=w.device)
    b[:w.shape[1], :w.shape[0]] = w.t()
    return b.view(torch.int32)


def _core_matrices(w, depth, cols):
    """w [k, n] in bf16 as wgmma's K-major B operand without swizzle, one
    block of 128 columns after the other: per block [depth / 16 k-steps]
    [16 groups of 8 columns][2 halves of 8 k][8 columns][8 k], so a k-step
    is 4096 contiguous bytes of 8 x 8 core matrices (16 bytes a column),
    the two k halves 128 bytes apart and the column groups 256 (the lbo
    and sbo of csrc/wgmma_bf16.cuh's descriptor); zero past w. As int32
    words (pairs of k, the lower in the low half)."""
    b = torch.zeros((depth, cols), dtype=torch.bfloat16, device=w.device)
    b[:w.shape[0], :w.shape[1]] = w
    b = b.view(depth // 16, 2, 8, cols // PACK_COLS, 16, 8)   # ks h e s j r
    return b.permute(3, 0, 4, 1, 5, 2).contiguous().view(torch.int32)


def pack_layout(Fs, Fd, G, C):
    """Shapes of pack_bf16's two parts in bf16 values: the projections
    [4, GCp / 128, depth / 16, 16, 2, 8, 8] (_core_matrices, depth the
    wider F padded to 16) and Wl2 [G, Cp, Cp + 8] (_words as bf16 halves);
    csrc/edge_stage_bf16.cu's np_fp, np_gcp, eb_cp, eb_kp."""
    GCp = (G * C + PACK_COLS - 1) // PACK_COLS * PACK_COLS
    Cp = _pad16(C)
    return ((4, GCp // PACK_COLS, _pad16(max(Fs, Fd)) // 16, 16, 2, 8, 8),
            (G, Cp, Cp + 8))


def _build_pack(conv):
    G, C = conv.num_gates, conv.out_channels
    Fs, Fd = conv.key.w.shape[0], conv.query.w.shape[0]
    (_, slices, steps, *_), (_, Cp, _) = pack_layout(Fs, Fd, G, C)
    pos = torch.zeros_like(conv.key.w[:3])
    proj = torch.stack([_core_matrices(w, 16 * steps, slices * PACK_COLS)
                        for w in (torch.cat([pos, conv.key.w[3:]]),
                                  torch.cat([pos, conv.value.w[3:]]),
                                  conv.query.w, conv.skip.w)])
    l2 = torch.stack([_words(conv.l2.w[g], Cp, Cp) for g in range(G)])
    return torch.cat([proj.reshape(-1), l2.reshape(-1)])


def _cached(cache, conv, ws, build):
    """build(conv), cached in `cache` per conv under a key of each weight
    of ws: its data_ptr, version and device."""
    key = None
    if not any(w.is_inference() for w in ws):
        key = tuple((w.data_ptr(), w._version, str(w.device)) for w in ws)
        hit = cache.get(conv)
        if hit is not None and hit[0] == key:
            return hit[1]
    with torch.no_grad():
        pack = build(conv)
    if key is not None:
        cache[conv] = (key, pack)
    return pack


def pack_bf16(conv):
    """The bf16 weights of `conv` as csrc/edge_stage_bf16.cu reads them, one
    int32 tensor on the weights' device: the projections Wk and Wv (their
    position rows 0..2 zeroed), Wq and Wskip as wgmma's B operands
    (_core_matrices: G*C padded to 128 columns, depth max(F) padded to
    16), then Wl2 as [G, Cp, Cp / 2 + 4] words (_words, mma.sync's B
    fragments; C padded to 16); each value bf16_round of the weight. A
    plain function, the same on the CPU; cached per conv under a key of
    each weight's data_ptr, version and device, so a weight changed in
    place (w.add_(), an optimizer step) or replaced gives a new pack, and
    unchanged weights give the cached one. Weights that are inference
    tensors (no version counter) are packed anew at every call. A write
    through `.data` (`w.data.copy_(v)`) does not move the version counter
    and is not seen: write weights in place under torch.no_grad()
    (`w.copy_(v)`, as load_state_dict and the optimizers do) or assign
    a new tensor."""
    ws = (conv.key.w, conv.value.w, conv.query.w, conv.skip.w, conv.l2.w)
    return _cached(_packs, conv, ws, _build_pack)


def tf32_round(x):
    """x rounded to TF32 as cvt.rna.tf32.f32 does (to nearest, ties away
    from zero, the 13 low mantissa bits cleared; infinities and NaNs keep
    their exponent), as fp32."""
    u = x.contiguous().view(torch.int32)
    finite = (u & 0x7F800000) != 0x7F800000
    return (torch.where(finite, u + 0x1000, u) & -0x2000).view(torch.float32)


def split_tf32(w):
    """(hi, lo) with hi = tf32_round(w) and lo = tf32_round(w - hi), as
    csrc/mma_tf32.cuh's split_tf32 makes them: hi*hi + hi*lo + lo*hi keeps
    about 2^-21 of w's products."""
    hi = tf32_round(w)
    return hi, tf32_round(w - hi)


def pack_layout_tf32x3(Fs, Fd, G, C):
    """Shape of pack_tf32x3 in fp32 values: [4 products, GCp / 128 slices,
    2 planes (hi, lo), depth / 8 k-steps, 16 groups of 8 columns, 2 halves
    of 4 k, 8 columns, 4 k], depth the wider F padded to 8 (csrc/
    edge_stage.cu's np_fp, np_gcp)."""
    GCp = (G * C + PACK_COLS - 1) // PACK_COLS * PACK_COLS
    depth = (max(Fs, Fd) + 7) // 8 * 8
    return (4, GCp // PACK_COLS, 2, depth // 8, 16, 2, 8, 4)


def _tf32_planes(w, depth, cols):
    """w [k, n] split (split_tf32) into its hi and lo planes, each as
    wgmma's K-major TF32 B operand without swizzle, per block of 128
    columns: [slices][2 planes][depth / 8 k-steps][16 groups of 8 columns]
    [2 halves of 4 k][8 columns][4 k], so a k-step is 4096 contiguous bytes
    of 8 x 4 core matrices (16 bytes a column), the two k halves 128 bytes
    apart and the column groups 256 (the lbo and sbo of the descriptor);
    zero past w."""
    planes = torch.zeros((2, depth, cols), dtype=torch.float32, device=w.device)
    hi, lo = split_tf32(w)
    planes[0, :w.shape[0], :w.shape[1]] = hi
    planes[1, :w.shape[0], :w.shape[1]] = lo
    b = planes.view(2, depth // 8, 2, 4, cols // PACK_COLS, 16, 8)  # p ks h e s j r
    return b.permute(4, 0, 1, 5, 2, 6, 3)


def _build_pack_tf32x3(conv):
    G, C = conv.num_gates, conv.out_channels
    Fs, Fd = conv.key.w.shape[0], conv.query.w.shape[0]
    _, slices, _, steps, *_ = pack_layout_tf32x3(Fs, Fd, G, C)
    proj = torch.stack([_tf32_planes(w, 8 * steps, slices * PACK_COLS)
                        for w in (conv.key.w, conv.value.w, conv.query.w,
                                  conv.skip.w)])
    return proj.reshape(-1).view(torch.int32)


def pack_tf32x3(conv):
    """The fp32 node_proj's weights of `conv` (csrc/edge_stage.cu), one
    int32 tensor of fp32 bit patterns on the weights' device: Wk, Wv, Wq
    and Wskip whole, each split once into TF32 hi and lo planes
    (split_tf32, bit for bit the kernels' split_tf32) laid out as wgmma's B
    operand (_tf32_planes: G*C padded to 128 columns, depth max(F) padded
    to 8, pack_layout_tf32x3). Cached per conv as pack_bf16 is, under a
    key of the four weights, with the same rules for rebuilding it."""
    ws = (conv.key.w, conv.value.w, conv.query.w, conv.skip.w)
    return _cached(_packs_tf32x3, conv, ws, _build_pack_tf32x3)


def _l2_fragments(w, cp):
    """w [k, n] zero-padded to [cp, cp] in mma.sync m16n8k8's B fragment
    order: [cp / 8 k-steps][cp / 8 n8 tiles][8 columns][4 k][2 halves of the
    k-step], so lane 4 c + k of a warp finds its two values (k and k + 4 of
    column c) side by side."""
    b = torch.zeros((cp, cp), dtype=torch.float32, device=w.device)
    b[:w.shape[0], :w.shape[1]] = w
    steps = cp // 8
    return b.view(steps, 2, 4, steps, 8).permute(0, 3, 4, 2, 1)


def _build_pack_l2(conv):
    G, C = conv.num_gates, conv.out_channels
    cp = (C + 7) // 8 * 8
    return torch.stack([_l2_fragments(conv.l2.w[g], cp)
                        for g in range(G)]).reshape(-1).contiguous()


def pack_l2(conv):
    """The fp32 edge_attn's Wl2 of `conv` (csrc/edge_stage.cu), one fp32
    tensor on the weights' device: each gate's [C, C] block in mma.sync's B
    fragment order (_l2_fragments, C padded to a multiple of 8), the gates
    one after the other, so that a block brings its gates' part in with
    one bulk copy. Cached per conv as pack_bf16 is, under a key of Wl2,
    with the same rules for rebuilding it."""
    return _cached(_packs_l2, conv, (conv.l2.w,), _build_pack_l2)


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


def _aligned(precision, conv, *xs):
    # the bf16 kernels bring x and the biases in by bulk copies
    if precision == "bf16":
        for t in (*xs, conv.query.b, conv.key.b, conv.value.b, conv.skip.b):
            if t.data_ptr() % 16:
                raise ValueError("edge stage bf16: x_src, x_dst and the "
                                 "projections' biases must be 16-byte "
                                 "aligned")


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
    _aligned(precision, conv, x_src, x_dst)
    out = launch(_entry(precision, "conv"), _stream(x_src), conv, x_src,
                 x_dst, nbr, edge_len, nbr_mask, G, C, precision)
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
    _aligned(precision, conv, x_src, x_dst)
    out = launch_node_proj(_entry(precision, "node_proj"), _stream(x_src),
                           conv, x_src, x_dst, precision)
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
                           G, C, precision)
    if Nd > 0:
        _count("edge_attn", Fs, Fd, precision, K)
    return out


def _empty(n, GC, like):
    return torch.empty((n, GC), dtype=torch.float32, device=like.device)


def _proj_args(conv, x_src, x_dst, precision):
    (Ns, Fs), (Nd, Fd) = x_src.shape, x_dst.shape
    pack = pack_bf16(conv) if precision == "bf16" else pack_tf32x3(conv)
    w = [pack, conv.query.b, conv.key.b, conv.value.b, conv.skip.b]
    return [x_src.data_ptr(), Ns, Fs, x_dst.data_ptr(), Nd, Fd,
            *[t.data_ptr() for t in w]]


def _branch_arg(precision, counts):
    """(an fp32 entry's argument that gets a kernel's grid, a function that
    counts that branch in `counts`); nothing at bf16."""
    if precision == "bf16":
        return [], lambda: None
    branch = ctypes.c_int(-1)

    def count():
        if branch.value >= 0:
            counts[BRANCHES[branch.value]] += 1

    return [ctypes.addressof(branch)], count


def _attn_weights(conv, precision):
    if precision == "bf16":
        w = [pack_bf16(conv), conv.key.w, conv.value.w, conv.l2.b,
             conv.edge.w]
    else:
        w = [conv.key.w, conv.value.w, pack_l2(conv), conv.l2.b, conv.edge.w]
    return [t.data_ptr() for t in w]


def launch(fn, stream, conv, x_src, x_dst, nbr, edge_len, nbr_mask, G, C,
           precision="fp32"):
    """Allocate the output and scratch beside x_src and call the C entry
    `fn` of the fused conv at `precision` (the built kernel; tests pass a
    CPU build of the same source) on checked inputs."""
    (Ns, Fs), (Nd, Fd), K = x_src.shape, x_dst.shape, nbr.shape[1]
    GC = G * C
    kn, vn = _empty(Ns, GC, x_src), _empty(Ns, GC, x_src)
    q, sk, out = _empty(Nd, GC, x_src), _empty(Nd, GC, x_src), _empty(Nd, GC, x_src)
    if precision == "bf16":
        w = [pack_bf16(conv), conv.query.b, conv.key.b, conv.value.b,
             conv.skip.b, conv.key.w, conv.value.w, conv.l2.b, conv.edge.w]
    else:
        w = [pack_tf32x3(conv), conv.query.b, conv.key.b, conv.value.b,
             conv.skip.b, conv.key.w, conv.value.w, pack_l2(conv), conv.l2.b,
             conv.edge.w]
    branch, count = _branch_arg(precision, node_proj_branches)
    attn_branch, attn_count = _branch_arg(precision, edge_attn_branches)
    fn(
        x_src.data_ptr(), Ns, Fs, x_dst.data_ptr(), Nd, Fd,
        nbr.data_ptr(), edge_len.data_ptr(), nbr_mask.data_ptr(), K,
        *[t.data_ptr() for t in w],
        G, C, kn.data_ptr(), vn.data_ptr(), q.data_ptr(), sk.data_ptr(),
        out.data_ptr(), stream, *branch, *attn_branch,
    )
    count()
    attn_count()
    return out


def launch_node_proj(fn, stream, conv, x_src, x_dst, precision="fp32"):
    """Call the C entry `fn` of node_proj; returns (K, V, Q, skip)."""
    GC = conv.key.w.shape[1]
    Ns, Nd = x_src.shape[0], x_dst.shape[0]
    outs = (_empty(Ns, GC, x_src), _empty(Ns, GC, x_src),
            _empty(Nd, GC, x_src), _empty(Nd, GC, x_src))
    branch, count = _branch_arg(precision, node_proj_branches)
    fn(*_proj_args(conv, x_src, x_dst, precision), GC,
       *[t.data_ptr() for t in outs], stream, *branch)
    count()
    return outs


def launch_edge_attn(fn, stream, conv, x_src, x_dst, nbr, edge_len, nbr_mask,
                     proj, G, C, precision="fp32"):
    """Call the C entry `fn` of edge_attn on the projections `proj`."""
    (Ns, Fs), (Nd, Fd), K = x_src.shape, x_dst.shape, nbr.shape[1]
    out = _empty(Nd, G * C, x_src)
    branch, count = _branch_arg(precision, edge_attn_branches)
    fn(x_src.data_ptr(), Ns, Fs, x_dst.data_ptr(), Nd, Fd,
       nbr.data_ptr(), edge_len.data_ptr(), nbr_mask.data_ptr(), K,
       *[t.data_ptr() for t in proj], *_attn_weights(conv, precision),
       G, C, out.data_ptr(), stream, *branch)
    count()
    return out
