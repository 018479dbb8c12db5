"""kernels/edge_stage.pack_bf16, the bf16 weights of a conv in the layouts
of csrc/edge_stage_bf16.cu's products, pack_tf32x3, the fp32 node_proj's
TF32 hi and lo planes, and pack_l2, the fp32 edge_attn's Wl2 in B fragment
order (csrc/edge_stage.cu), on the CPU: each packed value is
period_conv.bf16_round of its weight, the split of csrc/mma_tf32.cuh's
split_tf32 (computed here another way), or the weight itself, at the place
the kernels read it (zeros elsewhere); each pack is cached per conv and
rebuilt exactly when one of its weights changes."""

import numpy as np
import pytest
import torch

from graingraphnn_torch.kernels import edge_stage
from graingraphnn_torch.ops import period_conv


def _conv(Fs, Fd, G, C, seed=0):
    conv = period_conv.PeriodConv(Fs, Fd, C, G)
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(torch.from_numpy(rng.normal(0, 0.3, p.shape)
                                     .astype(np.float32)))
    return conv


PACKS = {"bf16": edge_stage.pack_bf16, "tf32x3": edge_stage.pack_tf32x3,
         "l2": edge_stage.pack_l2}
# the weights each pack holds
HOLDS = {"bf16": ("key", "value", "query", "skip", "l2"),
         "tf32x3": ("key", "value", "query", "skip"), "l2": ("l2",)}


def _cases(kinds, values):
    """Each value for each pack kind; the bf16 cases keep their ids."""
    out = []
    for kind in kinds:
        for v in values:
            vid = "-".join(map(str, v)) if isinstance(v, tuple) else str(v)
            out.append(pytest.param(kind, *(v if isinstance(v, tuple) else (v,)),
                                    id=vid if kind == "bf16" else f"{kind}-{vid}"))
    return out


def _unpack(pack, Fs, Fd, G, C):
    """(projections [4, GCp, depth], Wl2 [G, Cp, Cp]) as fp32, value (p, n,
    k) the bf16 of W_p[k, n]: the projections' core matrices put back in
    place, Wl2's columns with their 8 halves of padding checked to be zero
    and dropped."""
    proj_shape, l2_shape = edge_stage.pack_layout(Fs, Fd, G, C)
    n_proj = int(np.prod(proj_shape)) // 2
    assert pack.dtype == torch.int32
    assert pack.shape == (n_proj + int(np.prod(l2_shape)) // 2,)
    P, slices, steps = proj_shape[:3]
    proj = pack[:n_proj].view(torch.bfloat16).view(proj_shape).float()
    # [p, s, ks, j, h, r, e] -> [p, s, j, r, ks, h, e] = [p, n, k]
    proj = proj.permute(0, 1, 3, 5, 2, 4, 6).reshape(P, slices * 128,
                                                      steps * 16)
    l2 = pack[n_proj:].view(torch.bfloat16).view(l2_shape).float()
    assert not l2[..., -8:].any()
    return proj, l2[..., :-8]


def _unpack_tf32x3(pack, Fs, Fd, G, C):
    """[4, 2, GCp, depth] fp32, value (p, plane, n, k) the hi (plane 0) or
    lo (1) part of W_p[k, n]: the core matrices put back in place."""
    shape = edge_stage.pack_layout_tf32x3(Fs, Fd, G, C)
    assert pack.dtype == torch.int32 and pack.shape == (int(np.prod(shape)),)
    P, slices, planes, steps = shape[:4]
    # [p, s, plane, ks, j, h, r, e] -> [p, plane, s, j, r, ks, h, e]
    return (pack.view(torch.float32).view(shape)
            .permute(0, 2, 1, 4, 6, 3, 5, 7)
            .reshape(P, planes, slices * 128, steps * 8))


def _tf32_ref(w):
    """w rounded to 11 significant bits, ties away from zero, by frexp in
    float64 (cvt.rna.tf32.f32 on finite normal values)."""
    m, e = np.frexp(w.astype(np.float64))
    return np.sign(m) * np.ldexp(np.floor(np.abs(m) * 2.0**11 + 0.5), e - 11)


def _check_tf32x3(conv, Fs, Fd, G, C):
    """Planes p = Wk, Wv, Wq, Wskip (whole: the fp32 edge kernel adds the
    position rows per edge from the same projections): hi = tf32(w), lo =
    tf32(w - hi) of W_p[k, n] at its place among 8 x 4 core matrices (n,
    k), depth max(F) padded to 8, G*C padded to 128 columns."""
    planes = _unpack_tf32x3(edge_stage.pack_tf32x3(conv), Fs, Fd, G, C)
    for p, w in enumerate((conv.key.w, conv.value.w, conv.query.w,
                           conv.skip.w)):
        w = w.detach().numpy()
        hi = _tf32_ref(w)
        lo = _tf32_ref(w.astype(np.float64) - hi)
        for plane, part in enumerate((hi, lo)):
            want = torch.zeros_like(planes[p, plane])
            want[:G * C, :w.shape[0]] = torch.from_numpy(part.T.astype(np.float32))
            assert torch.equal(planes[p, plane], want), (p, plane)


def _check_l2(conv, G, C):
    """Wl2[g] zero-padded to C padded to 8, in mma.sync m16n8k8's B fragment
    order: [g][k-step][n8 tile][lane 4 c + t][h] = W[g][8 ks + 4 h + t][8
    nt + c], the value itself."""
    cp = (C + 7) // 8 * 8
    pack = edge_stage.pack_l2(conv)
    assert pack.dtype == torch.float32 and pack.shape == (G * cp * cp,)
    frag = pack.view(G, cp // 8, cp // 8, 8, 4, 2)
    w = torch.zeros((G, cp, cp))
    w[:, :C, :C] = conv.l2.w.detach()
    for g, ks, nt, c, t, h in ((g, ks, nt, c, t, h) for g in range(G)
                               for ks in range(cp // 8) for nt in range(cp // 8)
                               for c in range(8) for t in range(4) for h in range(2)):
        assert frag[g, ks, nt, c, t, h] == w[g, 8 * ks + 4 * h + t, 8 * nt + c]


@pytest.mark.parametrize("kind,Fs,Fd,G,C", _cases(
    PACKS, [(107, 104, 4, 96), (104, 107, 4, 96), (11, 9, 1, 30),
            (19, 8, 2, 128)]))
def test_pack_holds_the_rounded_weights_in_the_kernels_layout(kind, Fs, Fd,
                                                              G, C):
    """bf16: projections p = Wk, Wv, Wq, Wskip: W_p[k, n] at its place among
    8 x 8 core matrices (n, k), depth max(F) padded to 16, G*C padded to
    128 columns; Wk's and Wv's position rows 0..2 zero (x_src's lanes 0..2
    go in per edge). Wl2[g]: column n of the [C, C] block as one row of k
    pairs, C padded to 16. tf32x3: _check_tf32x3, with weights at the
    ties of TF32 rounding among them. l2: _check_l2."""
    conv = _conv(Fs, Fd, G, C, seed=Fs + C)
    if kind == "l2":
        return _check_l2(conv, G, C)
    if kind == "tf32x3":
        with torch.no_grad():
            conv.query.w[0, :4] = torch.tensor([1 + 2**-11, -(1 + 2**-11),
                                                3 * 2**-12, 1 + 3 * 2**-11])
        return _check_tf32x3(conv, Fs, Fd, G, C)
    proj, l2 = _unpack(edge_stage.pack_bf16(conv), Fs, Fd, G, C)
    r = period_conv.bf16_round
    GC = G * C
    for p, (w, f0) in enumerate(((conv.key.w, 3), (conv.value.w, 3),
                                 (conv.query.w, 0), (conv.skip.w, 0))):
        want = torch.zeros_like(proj[p])
        want[:GC, f0:w.shape[0]] = r(w.detach()[f0:]).t()
        assert torch.equal(proj[p], want), p
    for g in range(G):
        want = torch.zeros_like(l2[g])
        want[:C, :C] = r(conv.l2.w.detach()[g]).t()
        assert torch.equal(l2[g], want), g


@pytest.mark.parametrize("kind,name", _cases(
    PACKS, ["key", "value", "query", "skip", "l2"]))
def test_pack_is_rebuilt_after_an_in_place_update(kind, name):
    """An in-place update of any packed weight (as an optimizer step makes)
    gives a new pack holding the new values; the stale one is not used.
    An update of a weight that a pack does not hold leaves it as it is."""
    Fs, Fd, G, C = 107, 104, 4, 96
    pack = PACKS[kind]
    conv = _conv(Fs, Fd, G, C, seed=1)
    before = pack(conv)
    with torch.no_grad():
        getattr(conv, name).w.add_(0.25)
    after = pack(conv)
    if name not in HOLDS[kind]:
        assert after is before
        return
    assert after is not before and not torch.equal(after, before)
    assert torch.equal(after, pack(_clone(conv)))


def _clone(conv):
    other = period_conv.PeriodConv(conv.key.w.shape[0], conv.query.w.shape[0],
                                   conv.out_channels, conv.num_gates)
    other.load_state_dict(conv.state_dict())
    return other


def test_pack_is_rebuilt_for_a_replaced_weight():
    """A weight given new storage (a new parameter, or .data replaced)
    gives a new pack, of every kind."""
    for kind, pack in PACKS.items():
        conv = _conv(19, 8, 2, 16, seed=2)
        before = pack(conv)
        w = getattr(conv, HOLDS[kind][-1]).w
        w.data = w.data * 2
        after = pack(conv)
        assert after is not before
        assert torch.equal(after, pack(_clone(conv)))


def test_pack_is_not_rebuilt_for_unchanged_weights():
    """Unchanged weights give the cached pack, the same tensor, whatever
    else changes (biases and We are in no pack), and each conv has its
    own; the kinds of one conv are cached side by side."""
    for kind, make in PACKS.items():
        conv = _conv(107, 104, 4, 96, seed=3)
        pack = make(conv)
        other_kind = PACKS["tf32x3" if kind == "bf16" else "bf16"](conv)
        with torch.no_grad():
            conv.key.b.add_(1.0)
            conv.edge.w.add_(1.0)
        assert make(conv) is pack, kind
        assert PACKS["tf32x3" if kind == "bf16" else "bf16"](conv) is other_kind
        other = _conv(107, 104, 4, 96, seed=3)
        assert make(other) is not pack
        assert torch.equal(make(other), pack)


def test_pack_of_inference_weights_is_built_at_every_call():
    """Weights made under inference mode carry no version counter, so a
    change could not be seen: their pack is never cached."""
    for make in PACKS.values():
        with torch.inference_mode():
            conv = _conv(11, 9, 1, 30, seed=4)
            first = make(conv)
            second = make(conv)
        assert first is not second and torch.equal(first, second)


def test_bf16_bounds_count_the_packed_weights_at_two_bytes():
    """chip_smoke's bounds of the bf16 kernels count the weights as the
    kernels read them, the pack's bf16 values at 2 bytes each (Wk and Wv
    without their position rows, whose x_src lanes node_proj_bf16 does not
    need either), where the fp32 bounds count the fp32 matrices."""
    import chip_smoke

    Fs, Fd, G, C, Ns, Nd = 107, 104, 4, 96, 50, 70
    GC = G * C
    proj, l2 = _unpack(edge_stage.pack_bf16(_conv(Fs, Fd, G, C)), Fs, Fd,
                       G, C)
    n_proj, n_l2 = int(proj.count_nonzero()), int(l2.count_nonzero())
    assert (n_proj, n_l2) == (2 * GC * (Fs - 3 + Fd), G * C * C)
    xs, xd, mask = torch.zeros(Ns, Fs), torch.zeros(Nd, Fd), torch.ones(Nd, 16)
    _, b32 = chip_smoke.node_proj_cost(xs, xd, GC)
    _, b16 = chip_smoke.node_proj_cost(xs, xd, GC, bf16=True)
    assert b32 - b16 == 4 * 2 * GC * (Fs + Fd) - 2 * n_proj + 4 * 3 * Ns
    *_, e32 = chip_smoke.edge_attn_cost(xs, xd, mask, G, C)
    *_, e16 = chip_smoke.edge_attn_cost(xs, xd, mask, G, C, bf16=True)
    assert e32 - e16 == 4 * G * C * C - 2 * n_l2
