"""The port's CUDA kernels against their plain versions, on the card.

Run on a machine with an NVIDIA GPU and the CUDA toolkit (the JAX test
conftest is skipped: that machine has no JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card every test here skips (the check is made inside each test,
so every worker collects the same tests)."""

import numpy as np
import pytest
import torch

import chip_smoke
from graingraphnn_torch.kernels import edge_stage, editor_fused
from graingraphnn_torch.ops import period_conv
from graingraphnn_torch.rollout import device_driver as dd
from graingraphnn_torch.rollout import device_rollout as dr
from graingraphnn_torch.rollout import topology_jit as tj
from graingraphnn_torch.train import checkpoint

pytestmark = pytest.mark.cuda
ATOL, RTOL = 1e-4, 1e-4


def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def random_conv(seed, Fs, Fd, G, C, dev):
    conv = period_conv.PeriodConv(Fs, Fd, C, G)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in conv.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * 0.2)
    return conv.requires_grad_(False).to(dev)


# the decoder convs push, connect and pull of the benchmark's 64 lanes of
# 120 um (~1040 grains and ~2080 junctions a lane), at its pull ring of 32
BENCH_SHAPES = [(3, 66560, 133120, 107, 104), (3, 133120, 133120, 104, 104),
                (32, 133120, 66560, 104, 107)]


@pytest.mark.parametrize("K,Ns,Nd,Fs,Fd", [(3, 1043, 2086, 107, 104),
                                           (3, 2086, 2086, 104, 104),
                                           (16, 2086, 1043, 104, 107),
                                           (5, 77, 131, 19, 8)]
                         + BENCH_SHAPES)
def test_edge_stage_kernel_matches_plain(K, Ns, Nd, Fs, Fd):
    dev = card()
    G, C = 4, 96
    rng = np.random.default_rng(K + Nd)
    conv = random_conv(K, Fs, Fd, G, C, dev)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    xs = t(rng.uniform(0, 1, (Ns, Fs)).astype(np.float32))
    xd = t(rng.uniform(0, 1, (Nd, Fd)).astype(np.float32))
    nbr = t(rng.integers(0, Ns, (Nd, K)).astype(np.int32))
    ln = t(rng.uniform(0, 0.3, (Nd, K)).astype(np.float32))
    mask = (rng.uniform(size=(Nd, K)) < 0.8).astype(np.float32)
    mask[::9] = 0.0
    mask = t(mask)
    before = dict(edge_stage.launches)
    out = edge_stage.apply_period_conv_cuda(conv, xs, xd, nbr, ln, mask,
                                            num_gates=G, out_channels=C)
    ref = period_conv.apply_period_conv_plain(conv, xs, xd, nbr, ln, mask,
                                              num_gates=G, out_channels=C)
    torch.cuda.synchronize()
    assert edge_stage.launches == {k: v + 1 for k, v in before.items()}
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL)
    # the caller's choice: kernels=True sends CUDA tensors to the kernels
    again = period_conv.apply_period_conv(conv, xs, xd, nbr, ln, mask,
                                          num_gates=G, out_channels=C,
                                          kernels=True)
    assert edge_stage.launches == {k: v + 2 for k, v in before.items()}
    torch.testing.assert_close(again, out, atol=0, rtol=0)


def _ea_case(K, Ns, Nd, Fs, Fd, branch):
    return pytest.param(K, Ns, Nd, Fs, Fd, branch,
                        id="-".join(map(str, (K, Ns, Nd, Fs, Fd))))


@pytest.mark.parametrize("K,Ns,Nd,Fs,Fd,branch", [
    _ea_case(3, 1043, 2086, 107, 104, "persistent"),
    _ea_case(3, 2086, 2086, 104, 104, "persistent"),
    _ea_case(16, 2086, 1043, 104, 107, "persistent"),
    _ea_case(16, 234, 117, 104, 107, "one_wave"),
    # the benchmark's convs push, connect and pull at 64 lanes of 120 um
    # (fp32-hex64x120: 1047 grains and 2094 junctions a lane, pull ring 32)
    _ea_case(3, 67008, 134016, 107, 104, "persistent"),
    _ea_case(3, 134016, 134016, 104, 104, "persistent"),
    _ea_case(32, 134016, 67008, 104, 107, "persistent")])
def test_edge_attn_kernel_matches_plain_on_scattered_masks(K, Ns, Nd, Fs, Fd,
                                                            branch):
    """The edge kernel alone at the rollout's three conv shapes (one-gate
    blocks of several tiles), at a 40 um pull conv's (one wave) and at the
    benchmark's (blocks of all four gates), with live slots scattered over
    each row (not a prefix), rows with none live and rows with all K live;
    one launch, its grid asserted through edge_stage's branch counter."""
    dev = card()
    G, C = 4, 96
    rng = np.random.default_rng(Nd + K)
    conv = random_conv(Nd + K, Fs, Fd, G, C, dev)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    xs = t(rng.uniform(0, 1, (Ns, Fs)).astype(np.float32))
    xd = t(rng.uniform(0, 1, (Nd, Fd)).astype(np.float32))
    nbr = t(rng.integers(0, Ns, (Nd, K)).astype(np.int32))
    ln = t(rng.uniform(0, 0.3, (Nd, K)).astype(np.float32))
    mask = (rng.uniform(size=(Nd, K)) < 0.5).astype(np.float32)
    mask[::5] = 0.0
    mask[1::5] = 1.0
    mask[2::5, ::2] = 0.0
    mask = t(mask)
    proj = period_conv.node_projections_plain(conv, xs, xd)
    before = edge_stage.launches["edge_attn"]
    branches = dict(edge_stage.edge_attn_branches)
    out = edge_stage.edge_attn_cuda(conv, xs, xd, nbr, ln, mask, proj,
                                    num_gates=G, out_channels=C)
    ref = period_conv.edge_attn_plain(conv, xs, xd, nbr, ln, mask, proj,
                                      num_gates=G, out_channels=C)
    torch.cuda.synchronize()
    assert edge_stage.launches["edge_attn"] == before + 1
    branches[branch] += 1
    assert edge_stage.edge_attn_branches == branches
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL)


def _np_case(Ns, Nd, Fs, Fd, branch):
    return pytest.param(Ns, Nd, Fs, Fd, branch,
                        id="-".join(map(str, (Ns, Nd, Fs, Fd))))


@pytest.mark.parametrize("Ns,Nd,Fs,Fd,branch", [
    _np_case(1043, 2086, 107, 104, "one_wave"),
    _np_case(2086, 2086, 104, 104, "one_wave"),
    _np_case(2086, 1043, 104, 107, "one_wave"),
    _np_case(1, 65, 19, 8, "one_wave"),
    *[_np_case(Ns, Nd, Fs, Fd, "persistent")
      for _, Ns, Nd, Fs, Fd in BENCH_SHAPES]])
def test_node_proj_kernel_matches_plain(Ns, Nd, Fs, Fd, branch):
    """The grouped 3xTF32 node projections at the rollout's three conv
    shapes (and a ragged one), one wave of a tile a warpgroup, and at the
    benchmark's 64 x 120 um shapes, persistent blocks; one launch for all
    four products."""
    dev = card()
    G, C = 4, 96
    rng = np.random.default_rng(Ns + Fs)
    conv = random_conv(Nd, Fs, Fd, G, C, dev)
    xs = torch.from_numpy(rng.uniform(0, 1, (Ns, Fs)).astype(np.float32)).to(dev)
    xd = torch.from_numpy(rng.uniform(0, 1, (Nd, Fd)).astype(np.float32)).to(dev)
    before = edge_stage.launches["node_proj"]
    branches = dict(edge_stage.node_proj_branches)
    out = edge_stage.node_proj_cuda(conv, xs, xd)
    torch.cuda.synchronize()
    assert edge_stage.launches["node_proj"] == before + 1
    branches[branch] += 1
    assert edge_stage.node_proj_branches == branches
    for o, r in zip(out, period_conv.node_projections_plain(conv, xs, xd)):
        torch.testing.assert_close(o, r, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("K,Ns,Nd,Fs,Fd", [(3, 1043, 2086, 107, 104),
                                           (3, 2086, 2086, 104, 104),
                                           (16, 2086, 1043, 104, 107),
                                           (33, 77, 131, 19, 8)])
def test_bf16_edge_stage_kernels_match_plain(K, Ns, Nd, Fs, Fd):
    """The bf16 kernels at the rollout's three conv shapes (and K = 33, F
    odd): the fused conv, node_proj_bf16 and edge_attn_bf16 alone against
    the plain bf16 versions at chip_smoke's bf16 limits, counted as bf16
    launches only; the fp32 conv reads above the mean limit."""
    dev = card()
    G, C = 4, 96
    rng = np.random.default_rng(K + Nd + 1)
    conv = random_conv(K + 1, Fs, Fd, G, C, dev)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    xs = t(rng.uniform(0, 1, (Ns, Fs)).astype(np.float32))
    xd = t(rng.uniform(0, 1, (Nd, Fd)).astype(np.float32))
    nbr = t(rng.integers(0, Ns, (Nd, K)).astype(np.int32))
    ln = t(rng.uniform(0, 0.3, (Nd, K)).astype(np.float32))
    mask = (rng.uniform(size=(Nd, K)) < 0.6).astype(np.float32)
    mask[::5] = 0.0
    mask[1::5] = 1.0
    mask[2::5, ::2] = 0.0
    mask = t(mask)
    kw = dict(num_gates=G, out_channels=C, precision="bf16")
    fp32, bf16 = dict(edge_stage.launches), dict(edge_stage.bf16_launches)
    out = edge_stage.apply_period_conv_cuda(conv, xs, xd, nbr, ln, mask, **kw)
    ref = period_conv.apply_period_conv_plain(conv, xs, xd, nbr, ln, mask,
                                              **kw)
    chip_smoke.close_bf16("fused bf16", out, ref)
    assert edge_stage.launches == fp32
    assert edge_stage.bf16_launches == {k: v + 1 for k, v in bf16.items()}
    proj = period_conv.node_projections_plain(conv, xs, xd, "bf16")
    for o, r in zip(edge_stage.node_proj_cuda(conv, xs, xd, "bf16"), proj):
        torch.testing.assert_close(o, r, atol=ATOL, rtol=RTOL)
    out = edge_stage.edge_attn_cuda(conv, xs, xd, nbr, ln, mask, proj, **kw)
    chip_smoke.close_bf16("edge_attn_bf16", out, period_conv.edge_attn_plain(
        conv, xs, xd, nbr, ln, mask, proj, **kw))
    again = period_conv.apply_period_conv(conv, xs, xd, nbr, ln, mask,
                                          kernels=True, **kw)
    assert edge_stage.bf16_launches == {k: v + 3 for k, v in bf16.items()}
    planted = edge_stage.apply_period_conv_cuda(
        conv, xs, xd, nbr, ln, mask, num_gates=G, out_channels=C)
    with pytest.raises(RuntimeError, match="mean abs err"):
        chip_smoke.close_bf16("fp32 against bf16", planted, ref)
    chip_smoke.close_bf16("fused bf16, again", again, ref)


@pytest.mark.parametrize("K,Ns,Nd,Fs,Fd", [
    (3, 64 * 3 + 13, 64 * 2 + 13, 107, 104),   # ragged tiles, odd F
    (16, 141, 64 + 13, 104, 107),              # pull, ragged
    (3, 4181, 8362, 107, 104),                 # the 240 um push conv
    (3, 8362, 8362, 104, 104),                 # connect
    (16, 8362, 4181, 104, 107),                # pull
])
def test_bf16_kernels_at_ragged_and_240um_shapes(K, Ns, Nd, Fs, Fd):
    """node_proj_bf16 (persistent blocks over several row tiles, a ragged
    last tile, F = 107 at its unaligned row stride) and edge_attn_bf16
    against their plain bf16 versions at chip_smoke's bf16 limits, one
    bf16 launch each and no fp32 launch."""
    dev = card()
    G, C = 4, 96
    rng = np.random.default_rng(K + Ns + Nd)
    conv = random_conv(Ns, Fs, Fd, G, C, dev)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    xs = t(rng.uniform(0, 1, (Ns, Fs)).astype(np.float32))
    xd = t(rng.uniform(0, 1, (Nd, Fd)).astype(np.float32))
    nbr = t(rng.integers(0, Ns, (Nd, K)).astype(np.int32))
    ln = t(rng.uniform(0, 0.3, (Nd, K)).astype(np.float32))
    mask = (rng.uniform(size=(Nd, K)) < 0.6).astype(np.float32)
    mask[::5] = 0.0
    mask[1::5] = 1.0
    mask = t(mask)
    kw = dict(num_gates=G, out_channels=C, precision="bf16")
    fp32, bf16 = dict(edge_stage.launches), dict(edge_stage.bf16_launches)
    proj = period_conv.node_projections_plain(conv, xs, xd, "bf16")
    for o, r in zip(edge_stage.node_proj_cuda(conv, xs, xd, "bf16"), proj):
        torch.testing.assert_close(o, r, atol=ATOL, rtol=RTOL)
    out = edge_stage.edge_attn_cuda(conv, xs, xd, nbr, ln, mask, proj, **kw)
    chip_smoke.close_bf16("edge_attn_bf16", out, period_conv.edge_attn_plain(
        conv, xs, xd, nbr, ln, mask, proj, **kw))
    torch.cuda.synchronize()
    assert edge_stage.launches == fp32
    assert edge_stage.bf16_launches == {k: v + 1 for k, v in bf16.items()}


def test_bf16_kernels_follow_an_in_place_weight_update():
    """After w.add_() on every packed weight (an optimizer's step) the
    kernels compute with the new weights: the pack is rebuilt, never used
    stale."""
    dev = card()
    G, C, K, Ns, Nd, Fs, Fd = 4, 96, 3, 1043, 2086, 107, 104
    rng = np.random.default_rng(5)
    conv = random_conv(5, Fs, Fd, G, C, dev)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    xs = t(rng.uniform(0, 1, (Ns, Fs)).astype(np.float32))
    xd = t(rng.uniform(0, 1, (Nd, Fd)).astype(np.float32))
    nbr = t(rng.integers(0, Ns, (Nd, K)).astype(np.int32))
    ln = t(rng.uniform(0, 0.3, (Nd, K)).astype(np.float32))
    mask = t((rng.uniform(size=(Nd, K)) < 0.7).astype(np.float32))
    kw = dict(num_gates=G, out_channels=C, precision="bf16")
    before = edge_stage.apply_period_conv_cuda(conv, xs, xd, nbr, ln, mask,
                                               **kw)
    pack = edge_stage.pack_bf16(conv)
    with torch.no_grad():
        for d in (conv.key, conv.value, conv.query, conv.skip, conv.l2):
            d.w.add_(0.05)
    out = edge_stage.apply_period_conv_cuda(conv, xs, xd, nbr, ln, mask, **kw)
    assert edge_stage.pack_bf16(conv) is not pack
    ref = period_conv.apply_period_conv_plain(conv, xs, xd, nbr, ln, mask,
                                              **kw)
    chip_smoke.close_bf16("bf16 conv after the update", out, ref)
    assert float((out - before).abs().max()) > 1e-2


def test_pallas_span_on_the_card_matches_the_cpu_span(state120):
    """One span of the 120 um fixture with pallas=True on the card against
    the CPU's plain bf16 span (chip_smoke.bf16_span_card_vs_cpu: the span
    and one more forward on the card, 12 + 12 bf16 launches each, no fp32
    conv launch)."""
    dev = card()
    path = "artifacts/40um/"
    models = [checkpoint.load_model(path + name, d)[0]
              for d in (dev, "cpu") for name in ("regressor0", "classifier1")]
    edge_stage.reset_counts()
    with torch.no_grad():
        res = chip_smoke.bf16_span_card_vs_cpu(*models, state120)
    assert edge_stage.bf16_launches == {"node_proj": 24, "edge_attn": 24}
    assert edge_stage.launches == {"node_proj": 0, "edge_attn": 0}
    assert res["position_max_abs_err"] <= chip_smoke.BF16_POS_MAX


def test_edge_stage_kernel_refuses_what_it_cannot_take():
    dev = card()
    conv = random_conv(0, 11, 8, 4, 8, dev)
    xs, xd = torch.rand(9, 11, device=dev), torch.rand(7, 8, device=dev)
    nbr = torch.zeros(7, 65, dtype=torch.int32, device=dev)
    f = torch.ones(7, 65, device=dev)
    with pytest.raises(ValueError, match="K<=64"):
        edge_stage.apply_period_conv_cuda(conv, xs, xd, nbr, f, f,
                                          num_gates=4, out_channels=8)
    with pytest.raises(ValueError, match="contiguous"):
        edge_stage.apply_period_conv_cuda(
            conv, xs.double(), xd, nbr[:, :3].contiguous(), f[:, :3], f[:, :3],
            num_gates=4, out_channels=8)
    wide = random_conv(0, 11, 8, 1, 129, dev)
    with pytest.raises(ValueError, match="C<=128"):
        edge_stage.apply_period_conv_cuda(
            wide, xs, xd, nbr[:, :3].contiguous(), f[:, :3].contiguous(),
            f[:, :3].contiguous(), num_gates=1, out_channels=129)


@pytest.fixture(scope="module")
def state120():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, edges, mask, lxd, patch = dd.load_fixture()
    st, _, _ = dd.init_scaled_state(x, edges, mask, lxd, patch, device="cuda")
    return st


@pytest.mark.parametrize("seed,n_switch,n_elim", [(0, 8, 2), (1, 24, 4),
                                                  (2, 0, 8), (3, 30, 0)])
def test_editor_kernel_matches_plain(state120, seed, n_switch, n_elim):
    dev = card()
    st = state120
    rng = np.random.default_rng(seed)
    E, Q = st.E_pp.cpu().numpy(), st.E_pq.cpu().numpy()
    logits = np.full(E.shape[1], dr.NEG, np.float32)
    logits[E[0] >= 0] = -50.0
    cand = np.nonzero((E[0] < E[1]) & (E[0] >= 0))[0]
    logits[cand[rng.choice(len(cand), n_switch, replace=False)]] = \
        rng.uniform(5.0, 15.0, n_switch)
    grains, counts = np.unique(Q[1][Q[1] >= 0], return_counts=True)
    ge = np.full(tj.MAX_ELIM, -1, np.int32)
    ge[:n_elim] = rng.choice(grains[np.argsort(counts, kind="stable")][:12],
                             n_elim, replace=False)
    NG, NJ = st.xg.shape[0], st.xj.shape[0]
    y_grain = np.stack([rng.uniform(-0.5, 0.5, NG), np.zeros(NG)], 1)
    ts = tj.TopoState(
        E_pp=st.E_pp, E_pq=st.E_pq, xj=st.xj,
        y_joint=torch.from_numpy(
            rng.uniform(-0.9, 0.9, (NJ, 2)).astype(np.float32)).to(dev),
        mask_g=st.mask_g, mask_j=st.mask_j, append_ptr=st.n_pp)
    before = editor_fused.launches
    chip_smoke.check_editor_case(
        ts, torch.from_numpy(logits).to(dev), torch.from_numpy(ge).to(dev),
        torch.from_numpy(y_grain.astype(np.float32)).to(dev), 0.6, NG)
    assert editor_fused.launches == before + 1


def test_span_on_the_card_matches_the_cpu_span(state120):
    dev = card()
    path = "artifacts/40um/"
    reg, _, _ = checkpoint.load_model(path + "regressor0", dev)
    cls, _, _ = checkpoint.load_model(path + "classifier1", dev)
    reg_c, _, _ = checkpoint.load_model(path + "regressor0", "cpu")
    cls_c, _, _ = checkpoint.load_model(path + "classifier1", "cpu")
    st = state120
    st_c = st.map(lambda v: v.cpu())
    edge_stage.reset_counts()
    editor_fused.launches = 0
    s1, aux1 = dr.device_step(reg, cls, st, c_threshold=0.99)
    assert edge_stage.launches == {"node_proj": 12, "edge_attn": 12}
    assert editor_fused.launches == 1
    s0, aux0 = dr.device_step(reg_c, cls_c, st_c, c_threshold=0.99)
    for f in ("E_pp", "E_pq", "mask_g", "mask_j", "n_pp"):
        assert torch.equal(getattr(s1, f).cpu(), getattr(s0, f)), f
    torch.testing.assert_close(s1.xj.cpu(), s0.xj, atol=1e-5, rtol=0)
    assert torch.equal(aux1["switching"].cpu(), aux0["switching"])


def test_editor_kernel_matches_plain_on_a_forced_elimination(state120):
    dev = card()
    st = state120
    ts = tj.TopoState(E_pp=st.E_pp, E_pq=st.E_pq, xj=st.xj,
                      y_joint=torch.zeros_like(st.xj[:, :2]),
                      mask_g=st.mask_g, mask_j=st.mask_j, append_ptr=st.n_pp)
    chain = chip_smoke.forced_out_chain(ts)
    assert chain
    for s, logits, ge, yg in chain:
        (_, _, extra), _ = chip_smoke.check_editor_case(
            chip_smoke._to(s, dev), logits.to(dev), ge.to(dev), yg.to(dev),
            0.6, st.xg.shape[0])
    assert int((extra >= 0).sum()) == 1


def test_span_makes_no_host_sync(state120):
    """The span loop never waits for the device: PyTorch's sync debug mode
    turns any synchronizing call inside device_step into an error."""
    dev = card()
    reg, _, _ = checkpoint.load_model("artifacts/40um/regressor0", dev)
    cls, _, _ = checkpoint.load_model("artifacts/40um/classifier1", dev)
    st, _ = dr.device_step(reg, cls, state120, c_threshold=0.99)   # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            st, _ = dr.device_step(reg, cls, st, c_threshold=0.99)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.parametrize("K", [17, 24, 32, 64, 16, 40])
def test_edge_attn_kernel_takes_wide_rings(K):
    """Pull rings past 16 slots, as the host engine sizes them, at full
    width: the fused conv and the edge kernel alone against their plain
    versions, with rows whose live slots all lie past slot 31 and rows of
    one live slot, the last. The order (64 before 16 and 40) checks that a
    smaller ring after a larger one launches under the raised shared
    memory attribute."""
    dev = card()
    G, C, Ns, Nd, Fs, Fd = 4, 96, 2086, 1043, 104, 107
    rng = np.random.default_rng(K)
    conv = random_conv(K, Fs, Fd, G, C, dev)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    xs = t(rng.uniform(0, 1, (Ns, Fs)).astype(np.float32))
    xd = t(rng.uniform(0, 1, (Nd, Fd)).astype(np.float32))
    nbr = t(rng.integers(0, Ns, (Nd, K)).astype(np.int32))
    ln = t(rng.uniform(0, 0.3, (Nd, K)).astype(np.float32))
    mask = (rng.uniform(size=(Nd, K)) < 0.6).astype(np.float32)
    mask[::5] = 0.0
    mask[1::5] = 1.0
    mask[2::5, : K // 2] = 0.0
    mask[3::5] = 0.0
    mask[3::5, K - 1] = 1.0
    mask = t(mask)
    kw = dict(num_gates=G, out_channels=C)
    before = dict(edge_stage.launches)
    out = edge_stage.apply_period_conv_cuda(conv, xs, xd, nbr, ln, mask, **kw)
    ref = period_conv.apply_period_conv_plain(conv, xs, xd, nbr, ln, mask,
                                              **kw)
    torch.cuda.synchronize()
    assert edge_stage.launches == {k: v + 1 for k, v in before.items()}
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL)
    proj = period_conv.node_projections_plain(conv, xs, xd)
    out = edge_stage.edge_attn_cuda(conv, xs, xd, nbr, ln, mask, proj, **kw)
    ref = period_conv.edge_attn_plain(conv, xs, xd, nbr, ln, mask, proj, **kw)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref, atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("jit_editor,density", [(False, 0.0), (True, 0.0),
                                                (True, 1e-2), (False, 1e-2)])
def test_engine_span_on_the_card_matches_the_cpu(jit_editor, density):
    """One span of the host engine (the CLI's default rollout) on the
    generated 40 um graph with the shipped checkpoints, on the card and on
    the CPU from the same state, without and with nucleation: 12 + 12 edge
    stage launches (and one editor launch with jit_editor), topology
    bit-equal unless a switch probability lies within 1e-5 of the
    threshold, positions within 1e-5."""
    from graingraphnn_torch.data import extraction
    from graingraphnn_torch.rollout.engine import RolloutEngine

    dev = card()
    edits, logits = {}, {}
    for d in (dev, torch.device("cpu")):
        reg, _, _ = checkpoint.load_model("artifacts/40um/regressor0", d)
        cls, _, _ = checkpoint.load_model("artifacts/40um/classifier1", d)
        traj = extraction.generate(40, 3, 4.0, 1.0)
        hg0 = extraction.make_test_sample(traj, span=6)
        eng = RolloutEngine(reg, cls, c_threshold=0.9, r_threshold=3e-3,
                            jit_editor=jit_editor, seed=11, device=d)
        edit = eng._jit_update if jit_editor else eng.editor.update
        forward = eng._forward

        def keep_edit(*a, _edit=edit, _d=d.type, **k):
            out = _edit(*a, **k)
            edits[_d] = (out[1], out[2], out[3], a[3], out[0]["joint"].copy())
            return out

        def keep_logits(*a, _d=d.type, **k):
            out = forward(*a, **k)
            logits[_d] = out[0][1]["edge_event"]
            return out

        eng._forward = keep_logits
        if jit_editor:
            eng._jit_update = keep_edit
        else:
            eng.editor.update = keep_edit
        edge_stage.reset_counts()
        editor_fused.launches = 0
        with torch.no_grad():
            res = eng.run(hg0, traj, span=6, compare=False, growth_height=2.6,
                          nucleation_density=density)
        assert (res["num_grains_final"] > traj.num_regions) == (density > 0)
        if d.type == "cuda":
            assert edge_stage.launches == {"node_proj": 12, "edge_attn": 12}
            assert editor_fused.launches == int(jit_editor)
    p = 1.0 / (1.0 + np.exp(-np.asarray(logits["cpu"], np.float64)))
    near = bool((np.abs(p - 0.9) < 1e-5).any())
    (e1, sw1, ex1, m1, xj1), (e0, sw0, ex0, m0, xj0) = (edits["cuda"],
                                                       edits["cpu"])
    same = (all(np.array_equal(e1[k], e0[k]) for k in e0)
            and all(np.array_equal(m1[k], m0[k]) for k in m0)
            and np.array_equal(sw1, sw0) and np.array_equal(ex1, ex0))
    assert same or near
    if same:
        np.testing.assert_allclose(xj1[:, :2], xj0[:, :2], rtol=0, atol=1e-5)


@pytest.fixture(scope="module")
def pf121():
    """chip_smoke's synthetic phase-field simulation (121 frames) in
    memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return chip_smoke.synthetic_pf_arrays()


@pytest.mark.parametrize("mode", ["host", "jit_editor", "device_resident"])
def test_pf_span_with_compare_on_the_card_matches_the_cpu(pf121, mode):
    """One span with compare on from the synthetic PF simulation's first
    frame (test-mode extraction), on the card and on the CPU: the host
    engine with either editor, and the device-resident rollout. Topology
    bit-equal and the layer errors equal unless a switch probability lies
    within 1e-5 of the threshold, positions within 1e-5."""
    dev = card()
    with torch.no_grad():
        if mode == "device_resident":
            traj, hg0 = chip_smoke.pf_start(pf121)
            out = chip_smoke.pf_device_span_card_vs_cpu(
                dd.trajectory_from_extractor(traj, hg0), dev)
        else:
            out = chip_smoke.engine_span_card_vs_cpu(
                mode == "jit_editor", 0.0, dev,
                start=lambda: chip_smoke.pf_start(pf121), compare=True)
    assert len(out["layer_err_list"]) == 2
    assert (out["topology_equal"] and out["layer_err_equal"]) or \
        out["threshold_adjacent"]


@pytest.fixture(scope="module")
def gen40():
    """The generated 40 um starting graph (seed 3, G 4, R 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return dd.generate_trajectory(40, 3, 4.0, 1.0)


def test_generated_40um_span_on_the_card_matches_the_cpu(gen40):
    """One span of the generated graph on the card against the CPU, from
    the same state: topology bit-equal unless a switch probability lies
    within 1e-5 of the threshold, positions within 1e-5."""
    dev = card()
    t = gen40
    spans = {}
    for d in (dev, torch.device("cpu")):
        reg, _, _ = checkpoint.load_model("artifacts/40um/regressor0", d)
        cls, _, _ = checkpoint.load_model("artifacts/40um/classifier1", d)
        st, _, _ = dd.init_scaled_state(t.x, t.edges, t.mask, t.lxd,
                                        t.patch_size, device=d)
        probs = []
        update = editor_fused.update_fused
        editor_fused.update_fused = lambda *a, **k: (
            probs.append(torch.sigmoid(a[1]).cpu()), update(*a, **k))[1]
        try:
            spans[d.type] = dr.device_step(reg, cls, st, c_threshold=0.99)
        finally:
            editor_fused.update_fused = update
    (s1, aux1), (s0, aux0) = spans["cuda"], spans["cpu"]
    near = bool(((probs[0] - 0.99).abs() < 1e-5).any())
    try:
        for f in ("E_pp", "E_pq", "mask_g", "mask_j", "n_pp"):
            assert torch.equal(getattr(s1, f).cpu(), getattr(s0, f)), f
        assert torch.equal(aux1["switching"].cpu(), aux0["switching"])
    except AssertionError:
        if not near:
            raise
    torch.testing.assert_close(s1.xj.cpu()[:, :2], s0.xj[:, :2], atol=1e-5,
                               rtol=0)


def test_incremental_span_makes_no_host_sync(gen40, monkeypatch):
    """The column tables' maintenance, fallback included, keeps the span
    free of host syncs."""
    dev = card()
    t = gen40
    reg, _, _ = checkpoint.load_model("artifacts/40um/regressor0", dev)
    cls, _, _ = checkpoint.load_model("artifacts/40um/classifier1", dev)
    st, _, _ = dd.init_scaled_state(t.x, t.edges, t.mask, t.lxd,
                                    t.patch_size, incremental=True,
                                    device=dev)
    assert st.pull_cols is not None
    st, _ = dr.device_step(reg, cls, st, c_threshold=0.99)     # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for touch_max in (dr.TOUCH_MAX, 2):
            monkeypatch.setattr(dr, "TOUCH_MAX", touch_max)
            st, _ = dr.device_step(reg, cls, st, c_threshold=0.99)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.fixture(scope="module")
def slack120():
    """The 120 um state with nucleation slack, its melt pool term at the
    generate workload's settings, and the melt pool's advance per span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    traj = dd.load_trajectory()
    st, offset_j, factor = dd.init_scaled_state(
        traj.x, traj.edges, traj.mask, traj.lxd, traj.patch_size,
        nucleation_slack=dd.NUCLEATION_SLACK, device="cuda")
    term, gap = dd.make_melt_term(chip_smoke.GEN["meltpool"], traj.lxd, 6,
                                  st.xj.shape[0], offset_j, factor, "cuda")
    return st, term, gap


@pytest.mark.parametrize("seed,n_switch,n_elim", [(3, 24, 8), (4, 12, 4)])
def test_windowed_editor_kernel_matches_plain(slack120, seed, n_switch,
                                              n_elim):
    """Nucleated rings and melt pool windows open where x < 0.5."""
    card()
    ts, logits, ge, yg, active_g = chip_smoke.windowed_editor_inputs(
        slack120[0], seed, n_switch, n_elim)
    before = editor_fused.launches
    chip_smoke.check_editor_case(ts, logits, ge, yg, 0.6, ts.mask_g.shape[0],
                                 active_g=active_g)
    assert editor_fused.launches == before + 1


def test_generate_span_makes_no_host_sync(slack120):
    """A span with the moving melt pool and nucleation never waits for the
    device either."""
    dev = card()
    st, term, gap = slack120
    reg, _, _ = checkpoint.load_model("artifacts/40um/regressor0", dev)
    cls, _, _ = checkpoint.load_model("artifacts/40um/classifier1", dev)
    rand = torch.ones(st.xj.shape[0], device=dev)
    rand[torch.tensor([5, 600, 1400])] = 0.0
    kw = dict(c_threshold=0.99, nuc_density_term=1.0, nuc_rand=rand,
              nuc_angles=torch.rand(tj.MAX_NUC, 2, device=dev),
              melt_term=term, melt_left=torch.tensor(20 * gap, device=dev))
    st, _ = dr.device_step(reg, cls, st, **kw)     # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            st, aux = dr.device_step(reg, cls, st, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert not bool(aux["nuc_overflow"])


def test_editor_kernel_over_lanes_matches_plain(state120, slack120):
    """One launch over 3 lanes of forced 120 um scenarios, one of them a
    nucleated state with slack under melt pool windows (so the lanes
    differ in size): the lanes against the plain editor, bit-equal, and
    each lane against the kernel on that lane alone."""
    dev = card()
    st = state120
    rng = np.random.default_rng(5)
    ts0 = tj.TopoState(
        E_pp=st.E_pp, E_pq=st.E_pq, xj=st.xj,
        y_joint=torch.from_numpy(rng.uniform(
            -0.9, 0.9, (st.xj.shape[0], 2)).astype(np.float32)).to(dev),
        mask_g=st.mask_g, mask_j=st.mask_j, append_ptr=st.n_pp)
    lanes = [chip_smoke.forced_editor_inputs(ts0, 0, 8, 2),
             chip_smoke.windowed_editor_inputs(slack120[0], 3, 24, 8),
             chip_smoke.forced_editor_inputs(ts0, 2, 30, 0)]
    ts, logits, ge, yg, ag = chip_smoke.stack_editor_lanes(lanes)
    NG = ts.mask_g.shape[1]
    before = editor_fused.launches
    chip_smoke.check_editor_case(ts, logits, ge, yg, 0.6, NG, active_g=ag)
    assert editor_fused.launches == before + 1
    prob = torch.sigmoid(logits)
    out = editor_fused.update_from_prob(ts, prob, ge, yg, 0.6, NG,
                                        active_g=ag)
    for b in range(len(lanes)):
        one = editor_fused.update_from_prob(
            ts.map(lambda v: v[b]), prob[b], ge[b], yg[b], 0.6, NG,
            active_g=ag[b])
        for f in ("E_pp", "E_pq", "mask_g", "mask_j", "append_ptr", "xj",
                  "y_joint"):
            assert torch.equal(getattr(out[0], f)[b], getattr(one[0], f)), f
        assert torch.equal(out[1][b], one[1]) and torch.equal(out[2][b],
                                                              one[2])


def test_editor_kernel_refuses_packed_budgets(state120):
    """A packed state of 8 lanes needs 192 switches and 64 grain events a
    launch, past the kernel's per-lane limits: the wrapper raises."""
    dev = card()
    st = state120
    ts = tj.TopoState(E_pp=st.E_pp, E_pq=st.E_pq, xj=st.xj,
                      y_joint=torch.zeros_like(st.xj[:, :2]),
                      mask_g=st.mask_g, mask_j=st.mask_j, append_ptr=st.n_pp)
    _, logits, ge, yg = chip_smoke.forced_editor_inputs(ts, 0, 8, 2)
    with pytest.raises(ValueError, match="at most 64 switches"):
        editor_fused.update_fused(ts, logits, ge, yg, 0.6, st.xg.shape[0],
                                  max_switch=8 * tj.MAX_SWITCH)
    ge64 = torch.full((8 * tj.MAX_ELIM,), -1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="16 grain events"):
        editor_fused.update_fused(ts, logits, ge64, yg, 0.6, st.xg.shape[0])


@pytest.fixture(scope="module")
def lanes40():
    """Two generated 40 um starting graphs (seeds 3 and 5, G 4, R 1)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return [dd.generate_trajectory(40, seed, 4.0, 1.0) for seed in (3, 5)]


def _stacked(trajs, dev, incremental=False):
    return dr.stack_states([dd.init_scaled_state(
        t.x, t.edges, t.mask, t.lxd, t.patch_size, incremental=incremental,
        device=dev)[0] for t in trajs])


def test_batched_span_on_the_card_matches_the_cpu(lanes40):
    """One batched span of two 40 um lanes on the card (one forward of
    each model and one editor launch for both lanes) against the CPU from
    the same state: every lane's topology bit-equal unless a switch
    probability lies within 1e-5 of the threshold, positions within
    1e-5."""
    dev = card()
    reg, _, _ = checkpoint.load_model("artifacts/40um/regressor0", dev)
    cls, _, _ = checkpoint.load_model("artifacts/40um/classifier1", dev)
    reg_c, _, _ = checkpoint.load_model("artifacts/40um/regressor0", "cpu")
    cls_c, _, _ = checkpoint.load_model("artifacts/40um/classifier1", "cpu")
    st = _stacked(lanes40, dev)
    edge_stage.reset_counts()
    editor_fused.launches = 0
    with torch.no_grad():
        out = chip_smoke.batched_span_card_vs_cpu(reg, cls, reg_c, cls_c, st)
    assert edge_stage.launches == {"node_proj": 12, "edge_attn": 12}
    assert editor_fused.launches == 1
    assert out["lanes"] == 2 and out["switches"] > 0


@pytest.mark.parametrize("incremental", [False, True])
def test_batched_span_makes_no_host_sync(lanes40, incremental):
    """The batched span never waits for the device, on the sort and on
    the lanes' column tables."""
    dev = card()
    reg, _, _ = checkpoint.load_model("artifacts/40um/regressor0", dev)
    cls, _, _ = checkpoint.load_model("artifacts/40um/classifier1", dev)
    st = _stacked(lanes40, dev, incremental)
    assert (st.pull_cols is not None) == incremental
    st, _ = dr.batched_step(reg, cls, st, c_threshold=0.99)    # warm-up
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            st, aux = dr.batched_step(reg, cls, st, c_threshold=0.99)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    assert aux["switching"].shape[0] == 2


@pytest.fixture(scope="module")
def train_batch8():
    """Eight synthetic 40 um training windows (120 grains, 240 joints),
    packed on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from graingraphnn_torch.graph import state as gstate
    from graingraphnn_torch.graph import synthetic

    samples = [gstate.build_sample(*synthetic.spatial_ring_arrays(120, seed=s),
                                   device="cuda") for s in range(8)]
    return gstate.pack(gstate.stack(samples))


@pytest.mark.parametrize("name", ["regressor0", "classifier1"])
def test_eval_forward_on_the_kernels_matches_the_torch_formulation(
        train_batch8, name):
    """The eval forward at a packed batch of 8: 6 node_proj and 6 edge_attn
    launches, outputs within atol = rtol = 1e-4 of the torch formulation."""
    dev = card()
    model, hp, _ = checkpoint.load_model(f"artifacts/40um/{name}", dev)
    edge_stage.reset_counts()
    with torch.no_grad():
        fast = model(train_batch8, kernels=True)
        assert edge_stage.launches == {"node_proj": 6, "edge_attn": 6}
        slow = model(train_batch8, kernels=False)
    assert edge_stage.launches == {"node_proj": 6, "edge_attn": 6}
    for k in fast:
        torch.testing.assert_close(fast[k], slow[k], atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("name", ["regressor0", "classifier1"])
def test_train_step_on_the_card_matches_the_cpu(train_batch8, name):
    """One train step's loss (rtol 1e-5) and gradients (atol 1e-5 + rtol
    1e-4) on the card against the CPU, same params and packed batch."""
    dev = card()
    model, hp, _ = checkpoint.load_model(f"artifacts/40um/{name}", dev)
    edge_stage.reset_counts()
    errs = chip_smoke.step_card_vs_cpu(model, hp, train_batch8)
    assert errs["loss_rel_err"] <= chip_smoke.TRAIN_LOSS_RTOL
    # the kernels ran only in the eval forward, never under autograd
    assert edge_stage.launches == {"node_proj": 6, "edge_attn": 6}


def test_editor_kernel_cleanup_mask_matches_plain(state120):
    """The cleanup mask cg on the card: chip_smoke's two-sided cases, the
    kernel against its plain version, the spared grain alive, a null mask
    the bits of a mask of all ones."""
    dev = card()
    models = [checkpoint.load_model(f"artifacts/40um/{m}", dev)[0]
              for m in ("regressor0", "classifier1")]
    with torch.no_grad():
        first = chip_smoke.editor_inputs(*models, state120)
    assert chip_smoke.editor_cleanup_mask_cases(
        first[0], state120.xg.shape[0]) <= chip_smoke.EDITOR_ATOL


def test_edge_stage_kernels_on_stripe_tables():
    """node_proj and edge_attn at the halo stripes' shapes of the 120 um
    fixture at D = 4 (3 * cap source rows, cap destination rows), against
    their plain versions (chip_smoke.conv_kernel_rows raises past the
    tolerance)."""
    dev = card()
    reg, cls = [checkpoint.load_model(f"artifacts/40um/{m}", dev)[0]
                for m in ("regressor0", "classifier1")]
    with torch.no_grad():
        inputs = chip_smoke.stripe_conv_inputs(reg, cls, dd.load_fixture(),
                                               4, dev)
        for _c, xs, xd, nbr, *_r in inputs.values():
            assert xs.shape[0] % 3 == 0 and xs.shape[0] > xd.shape[0]
            assert int(nbr.max()) >= xs.shape[0] // 3
        rows = chip_smoke.conv_kernel_rows(inputs, reg.hp.layer_size,
                                           suffix="_stripe",
                                           workload="partition")
    assert len(rows) == 6


def test_partitioned_spans_on_the_card(tmp_path):
    """Two gloo ranks sharing the card, 2 spans of the 120 um fixture:
    each rank launches the kernels on its stripe, and each span equals the
    one-device span from the same state (topology bit-equal, positions
    within 2e-5)."""
    card()
    from graingraphnn_torch.parallel import mesh as mesh_mod

    res = mesh_mod.launch(chip_smoke.partition_rank, 2, dd.load_fixture(), 2,
                          "span", device="cuda", store_dir=str(tmp_path))
    chip_smoke.check_partition_run("card test", res, 2, 2,
                                   mesh_mod.choose_backend(2, "cuda"))


def test_partitioned_spans_over_nccl_at_one_rank(tmp_path):
    """One rank alone on the card takes NCCL, and every collective of the
    partitioned span goes through it (the exchange sends to itself): 2
    spans, each equal to the one-device span."""
    card()
    from graingraphnn_torch.parallel import mesh as mesh_mod

    res = mesh_mod.launch(chip_smoke.partition_rank, 1, dd.load_fixture(), 2,
                          "span", device="cuda", store_dir=str(tmp_path))
    chip_smoke.check_partition_run("card test", res, 2, 1, "nccl")
    assert res[0]["transport"] == "device buffers over NCCL"
    assert res[0]["bytes_exchanged"] > 0
