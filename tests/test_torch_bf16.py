"""The port's bf16 edge stage against the JAX package's: the plain bf16
conv (the bf16 kernels' oracle) against the TPU kernel at its default
bf16 operands, run in interpret mode, and against JAX's fp32 conv at
JAX's own bf16 bound; the mixed-precision torch formulation against
JAX's set_compute_dtype(bfloat16) conv; both shipped models and one span
of make_rollout(pallas=True) against JAX's pallas=True forwards and scan;
and the pallas plumbing (modes, the CLI, the batched lanes).

JAX's period_conv imports apply_period_conv_pallas at call time, so the
tests that run JAX's pallas=True path patch that name to its interpret
mode; nothing in the JAX package changes."""

import functools
import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graingraphnn_torch.cli import test as cli
from graingraphnn_torch.graph.geometry import wrap_shift
from graingraphnn_torch.ops import period_conv as tpc
from graingraphnn_torch.ops import segment
from graingraphnn_torch.rollout import device_rollout as dr
from graingraphnn_torch.train import checkpoint
from graingraphnn_tpu.data import extraction
from graingraphnn_tpu.kernels import edge_stage as jes
from graingraphnn_tpu.ops import period_conv as jpc
from graingraphnn_tpu.rollout import device_driver as jdd
from graingraphnn_tpu.rollout import device_rollout as jdr
from graingraphnn_tpu.train import checkpoint as jck
from tests.test_device_rollout import make_traj
from tests.test_torch_period_conv import _case, _conv
from tests.util import synthetic_sample

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KERNEL_ATOL = 1e-5     # plain bf16 against JAX's bf16 kernel: the same
                       # roundings, fp32 sums in another order
MIXED_ATOL = 2e-6      # mixed formulation against JAX's, the same casts
# a model's forward runs 12 convs, and a bf16 rounding that flips in one
# (the sums' order differs) moves what the later ones read: at 40 um the
# port's bf16 forwards read 1.1e-7 to 6.1e-6 of the scale in the mean
# against JAX's (1-4 % of the outputs past 1e-5 of it), 2.2e-3 at most,
# and its fp32 forwards 1.4e-3 to 1.4e-2 in the mean; the limits lie
# between
MODEL_MEAN_REL, MODEL_MAX_REL = 1e-4, 1e-2
C_THRESHOLD = 0.99
# positions after one bf16 span from the same state, max and mean: the
# port's span read 1.3e-4 and 1.1e-7 against JAX's (a flip moves a few
# joints), its fp32 span 1.5e-2 and 2.0e-4
POS_MAX, POS_MEAN = 1e-3, 1e-5


def _inputs(case):
    params, xs, xd, nbr, elen, mask = case
    return params, [jnp.asarray(a) for a in (xs, xd, nbr, elen, mask)], \
        [torch.from_numpy(a) for a in (xs, xd, nbr, elen, mask)]


def _port_conv(case, G, C, **kw):
    params, _, t = _inputs(case)
    conv = _conv(params, t[0].shape[1], t[1].shape[1], G, C)
    with torch.no_grad():
        return tpc.apply_period_conv(conv, *t, num_gates=G, out_channels=C,
                                     **kw).numpy()


GCK = [(G, C, K) for K in (3, 16, 24) for G in (1, 4) for C in (8, 16, 96)]


@pytest.mark.parametrize("G,C,K", GCK)
def test_plain_bf16_matches_jax_bf16_kernel(G, C, K):
    """The plain bf16 conv (the CPU's kernels=True, precision="bf16") and
    the TPU kernel at compute_dtype=bfloat16 in interpret mode: K = 3
    takes its unrolled body, 16 and 24 its flat one; every 5th row fully
    masked, the other masks scattered."""
    case = _case(G * 1000 + C * 10 + K, G, C, K, Nd=30)
    params, j, _ = _inputs(case)
    ref = np.asarray(jes.apply_period_conv_pallas(
        params, *j, num_gates=G, out_channels=C, interpret=True,
        compute_dtype=jnp.bfloat16))
    out = _port_conv(case, G, C, kernels=True, precision="bf16")
    np.testing.assert_allclose(out, ref, rtol=0, atol=KERNEL_ATOL)


@pytest.mark.parametrize("edge", ["push", "pull"])
@pytest.mark.parametrize("G,C", [(1, 8), (4, 8), (4, 96)])
def test_plain_bf16_within_jax_bound_of_fp32(G, C, edge):
    """Against JAX's fp32 XLA conv at JAX's own bf16 bound, on the inputs
    of JAX's own test of it (tests/test_pallas_kernel.py: a synthetic
    sample, Glorot weights), and its mean above 1e-6 of the scale, so a
    bf16 path that silently computes fp32 fails."""
    s = synthetic_sample(ng=16, nj=32, seed=3)
    src, dst = ((s.grain_x, s.joint_x) if edge == "push"
                else (s.joint_x, s.grain_x))
    params = jpc.init_period_conv(jax.random.PRNGKey(2), src.shape[1],
                                  dst.shape[1], C, G)
    j = [src, dst, getattr(s, edge + "_nbr"), getattr(s, edge + "_len"),
         getattr(s, edge + "_mask")]
    ref = np.asarray(jpc.apply_period_conv(params, *j, num_gates=G,
                                           out_channels=C))
    params = jax.tree_util.tree_map(np.asarray, params)
    case = (params, *[np.asarray(a) for a in j])
    out = _port_conv(case, G, C, kernels=True, precision="bf16")
    scale = float(np.abs(ref).max())
    err = np.abs(out - ref)
    assert err.max() / scale < 5e-2, err.max() / scale
    assert 1e-6 < err.mean() / scale < 5e-3, err.mean() / scale


def _coo_reference_bf16(conv, x_src, x_dst, src, dst, edge_len, edge_mask,
                        G, C):
    """The naive per-edge formulation of the TPU kernel at bf16: the
    relocated source row [bf16(bf16(x_j) - bf16(x_i) + wrap), bf16(x_j[3:])]
    through the whole bf16 Wk and Wv per edge, a segment softmax per
    destination, alpha, relu and the logit products rounded to bf16."""
    r = tpc.bf16_round
    Nd = x_dst.shape[0]
    src, dst = src.long(), dst.long()
    x_j, x_i = r(x_src[src]), r(x_dst[dst])
    rel = x_j[:, :3] - x_i[:, :3]
    x_jp = torch.cat([r(rel + wrap_shift(rel)), x_j[:, 3:]], dim=1)
    q = x_i @ r(conv.query.w) + conv.query.b
    e = edge_len[:, None] * conv.edge.w
    k = x_jp @ r(conv.key.w) + conv.key.b + e
    v1 = x_jp @ r(conv.value.w) + conv.value.b
    v = torch.einsum("egc,gcd->egd", r(torch.relu(v1)).reshape(-1, G, C),
                     r(conv.l2.w)) + conv.l2.b
    logits = torch.sum(r(q.reshape(-1, G, C) * k.reshape(-1, G, C)),
                       dim=-1) / math.sqrt(C)
    alpha = r(torch.stack([segment.segment_softmax(logits[:, g], dst, Nd,
                                                   mask=edge_mask)
                           for g in range(G)], dim=-1))
    msg = (v + e.reshape(-1, G, C)) * alpha[..., None] \
        * edge_mask[:, None, None]
    return (segment.segment_sum(msg.reshape(-1, G * C), dst, Nd)
            + r(x_dst) @ r(conv.skip.w) + conv.skip.b)


@pytest.mark.parametrize("G,C,K", [(4, 8, 3), (1, 16, 16), (4, 96, 24)])
def test_bf16_decomposition_matches_per_edge_reference(G, C, K):
    """The shift decomposition at bf16 (per-node projections of the
    non-position lanes plus a rank-3 term of the rounded relocated
    positions) against the per-edge bf16 formulation."""
    case = _case(G * 7 + K, G, C, K, Nd=30)
    params, _, t = _inputs(case)
    conv = _conv(params, t[0].shape[1], t[1].shape[1], G, C)
    Nd = t[1].shape[0]
    dst = torch.arange(Nd).repeat_interleave(K)
    with torch.no_grad():
        ref = _coo_reference_bf16(conv, t[0], t[1], t[2].reshape(-1), dst,
                                  t[3].reshape(-1), t[4].reshape(-1), G, C)
        out = tpc.apply_period_conv_plain(conv, *t, num_gates=G,
                                          out_channels=C, precision="bf16")
    torch.testing.assert_close(out, ref, rtol=0, atol=KERNEL_ATOL)


class _UpcastEinsum(types.ModuleType):
    """jax.numpy with an einsum that takes preferred_element_type by
    casting its operands: JAX's CPU backend has no batched bf16 x bf16 ->
    fp32 dot, and bf16 operands are exact in fp32, so the product is the
    same."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def einsum(spec, *ops, preferred_element_type=None, **kw):
        if preferred_element_type is not None:
            ops = [o.astype(preferred_element_type) for o in ops]
        return jnp.einsum(spec, *ops, **kw)


@pytest.mark.parametrize("G,C,K,attention", [
    (1, 8, 3, True), (1, 16, 16, True), (4, 96, 16, True), (4, 16, 24, True),
    (4, 8, 3, False)])
def test_mixed_matches_jax_set_compute_dtype(G, C, K, attention,
                                             monkeypatch):
    """The differentiable mixed-precision formulation (kernels=False,
    precision="bf16") against JAX's XLA conv under
    set_compute_dtype(jnp.bfloat16), the global restored; for G > 1 JAX's
    l2 einsum runs on upcast operands (_UpcastEinsum). Its gradient
    reaches every parameter."""
    case = _case(G * 31 + K, G, C, K, Nd=30)
    params, j, t = _inputs(case)
    if G > 1:
        monkeypatch.setattr(jpc, "jnp", _UpcastEinsum("jnp"))
    jpc.set_compute_dtype(jnp.bfloat16)
    try:
        ref = np.asarray(jpc.apply_period_conv(
            params, *j, num_gates=G, out_channels=C, attention=attention))
    finally:
        jpc.set_compute_dtype(None)
    conv = _conv(params, t[0].shape[1], t[1].shape[1], G, C)
    out = tpc.apply_period_conv(conv, *t, num_gates=G, out_channels=C,
                                kernels=False, attention=attention,
                                precision="bf16")
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), ref, rtol=0,
                               atol=MIXED_ATOL)
    out.square().sum().backward()
    for name, p in conv.named_parameters():
        if name == "l2.b" or (not attention and name.startswith(
                ("query", "key"))):
            continue        # no path to the output (as in JAX)
        assert p.grad is not None and bool(torch.isfinite(p.grad).all()), \
            name
        assert float(p.grad.abs().max()) > 0, name


# ---------------------------------------------------------------------------
# the shipped models and the rollout on JAX's pallas=True path
# ---------------------------------------------------------------------------


@pytest.fixture
def jax_interpret(monkeypatch):
    """JAX's bf16 Pallas conv in interpret mode (it runs on the CPU)."""
    monkeypatch.setattr(jes, "apply_period_conv_pallas", functools.partial(
        jes.apply_period_conv_pallas, interpret=True))


@pytest.fixture(scope="module")
def setup40():
    traj = make_traj(5)
    hg0 = extraction.make_test_sample(traj, span=6)
    js, _, _ = jdd.init_scaled_state(hg0, traj)
    path = os.path.join(REPO, "artifacts", "40um")
    pr, hpr, _ = jck.load(os.path.join(path, "regressor0"))
    pc, hpc, _ = jck.load(os.path.join(path, "classifier1"))
    models = (checkpoint.params_from_jax(pr, hpr, "cpu"),
              checkpoint.params_from_jax(pc, hpc, "cpu"))
    return js, (pr, hpr, pc, hpc), models


def port_state(js):
    return dr.DeviceRolloutState(**{
        k: torch.from_numpy(np.array(getattr(js, k)))
        for k in ("xg", "xj", "E_pp", "E_pq", "mask_g", "mask_j", "n_pp")})


def test_shipped_models_bf16_forward_matches_jax(setup40, jax_interpret):
    """Both shipped models at 40 um on the bf16 path against JAX's
    forwards under use_pallas_kernels(True, bfloat16): the mean within
    MODEL_MEAN_REL of the scale, the max within MODEL_MAX_REL; the fp32
    forwards read above the mean limit."""
    js, (pr, hpr, pc, hpc), (reg, cls) = setup40
    old = (jpc._USE_PALLAS, jpc._PALLAS_DTYPE)
    jpc.use_pallas_kernels(True, jnp.bfloat16)
    try:
        _, jy_r, jy_c, _ = jax.jit(
            lambda s: jdr.forward_stage(pr, hpr, pc, hpc, s, 16))(js)
    finally:
        jpc.use_pallas_kernels(*old)
    _, y_r, y_c, _ = dr.forward_stage(reg, cls, port_state(js), 16, "bf16")
    _, f_r, _, _ = dr.forward_stage(reg, cls, port_state(js), 16)
    for out, ref in ((y_r, jy_r), (y_c, jy_c)):
        for k in ref:
            ref_k = np.asarray(ref[k])
            err = np.abs(out[k].numpy() - ref_k)
            scale = np.abs(ref_k).max()
            assert err.mean() <= MODEL_MEAN_REL * scale, (
                k, err.mean() / scale)
            assert err.max() <= MODEL_MAX_REL * scale, (k, err.max() / scale)
    for k in f_r:
        ref_k = np.asarray(jy_r[k])
        err = np.abs(f_r[k].numpy() - ref_k)
        assert err.mean() > MODEL_MEAN_REL * np.abs(ref_k).max(), k


def test_pallas_span_matches_jax(setup40, jax_interpret):
    """One span of make_rollout(pallas=True) from the JAX state against
    make_rollout_scan(pallas=True, n_steps=1): topology equal unless a
    switch probability lies within float noise of the threshold (as
    test_torch_device_rollout's spans), positions within POS_MAX and
    POS_MEAN."""
    js, (pr, hpr, pc, hpc), (reg, cls) = setup40
    js1, jaux = jdr.make_rollout_scan(pr, hpr, pc, hpc, n_steps=1,
                                      c_threshold=C_THRESHOLD, pallas=True,
                                      fused_editor=True)(js)
    ts, taux = dr.make_rollout(reg, cls, n_steps=1, c_threshold=C_THRESHOLD,
                               pallas=True)(port_state(js))
    _, _, y_c, _ = dr.forward_stage(reg, cls, port_state(js), 16, "bf16")
    prob = torch.sigmoid(y_c["edge_event"]).numpy()
    near = bool((np.abs(prob - C_THRESHOLD) < 1e-5).any())
    try:
        for k in ("E_pp", "E_pq", "mask_g", "mask_j", "n_pp"):
            np.testing.assert_array_equal(getattr(ts, k).numpy(),
                                          np.asarray(getattr(js1, k)),
                                          err_msg=k)
        for k in ("grain_events", "switching"):
            np.testing.assert_array_equal(taux[k].numpy(),
                                          np.asarray(jaux[k]), err_msg=k)
    except AssertionError:
        if not near:
            raise
    for k in ("xg", "xj"):
        err = np.abs(getattr(ts, k).numpy() - np.asarray(getattr(js1, k)))
        assert err.max() <= POS_MAX and err.mean() <= POS_MEAN, (
            k, err.max(), err.mean())
    assert int((taux["switching"][..., 0] >= 0).sum()) > 0


# ---------------------------------------------------------------------------
# plumbing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode,want,jax_mode", [
    (False, "fp32", (False, None)), (None, "fp32", (False, None)),
    ("fp32", "fp32", (True, jnp.float32)), (True, "bf16", (True, jnp.bfloat16)),
    ("bf16", "bf16", (True, jnp.bfloat16))])
def test_pallas_mode_maps_jax_values(mode, want, jax_mode):
    """JAX's modes and the port's precision for each: JAX's XLA conv and
    its fp32 Pallas conv both take the port's fp32 kernels."""
    assert jdr._pallas_mode(mode) == jax_mode
    assert dr._pallas_mode(mode) == want


@pytest.mark.parametrize("mode", ["fp16", "true", 2])
def test_pallas_mode_refuses_unknown_values(mode, setup40):
    _, _, (reg, cls) = setup40
    with pytest.raises(ValueError, match="pallas mode"):
        dr._pallas_mode(mode)
    with pytest.raises(ValueError, match="pallas mode"):
        jdr._pallas_mode(mode)
    for make in (dr.make_rollout, dr.make_rollout_batched):
        with pytest.raises(ValueError, match="pallas mode"):
            make(reg, cls, n_steps=1, pallas=mode)
    with pytest.raises(ValueError, match="precision"):
        tpc.apply_period_conv(None, None, None, None, None, None,
                              num_gates=1, out_channels=1, kernels=True,
                              precision=mode)


CLI_ARGS = ["--generate", "--platform", "cpu", "--model_dir",
            REPO + "/artifacts/40um", "--seed", "3", "--G", "4", "--R", "1"]


@pytest.mark.parametrize("extra,refused", [
    (["--device_resident", "--pallas"], False),
    (["--device_resident", "--pallas", "--partition", "4"], True),
    (["--pallas", "--partition", "4"], True),
    (["--pallas"], True)])
def test_cli_pallas_flag(extra, refused):
    """--pallas is taken with --device_resident, refused with --partition
    (JAX's words) and on the host engine."""
    if refused:
        with pytest.raises(SystemExit):
            cli._args(CLI_ARGS + extra)
    else:
        args, _ = cli._args(CLI_ARGS + extra)
        assert args.pallas and args.device_resident


def test_cli_pallas_runs_the_bf16_forwards(capsys, monkeypatch):
    """The CLI's --pallas reaches the forwards as precision "bf16" (two
    spans of the 40 um recipe on the CPU) and prints its JSON line."""
    seen = []
    real = dr.forward_stage

    def spy(*a, **kw):
        seen.append(a[4] if len(a) > 4 else kw.get("precision"))
        return real(*a, **kw)

    monkeypatch.setattr(dr, "forward_stage", spy)
    cli.main(CLI_ARGS + ["--device_resident", "--pallas", "--growth_height",
                         "5.0", "--eval_every", "2"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert '"events_pred"' in line
    assert seen and set(seen) == {"bf16"}


def test_batched_bf16_lanes_match_single_lanes(setup40):
    """Two lanes of a 2-span make_rollout_batched(pallas=True) against
    each lane's own single-lane bf16 run."""
    js, _, (reg, cls) = setup40
    traj7 = make_traj(7)
    js7, _, _ = jdd.init_scaled_state(
        extraction.make_test_sample(traj7, span=6), traj7)
    singles = [port_state(js), port_state(js7)]
    kw = dict(n_steps=2, c_threshold=0.9, pallas=True)
    out, aux = dr.make_rollout_batched(reg, cls, **kw)(
        dr.stack_states(singles))
    assert aux["switching"].shape[:2] == (2, 2)
    for i, s in enumerate(singles):
        one, _ = dr.make_rollout(reg, cls, **kw)(s)
        ng, nj = one.xg.shape[0], one.xj.shape[0]
        np.testing.assert_allclose(out.xg[i, :ng].numpy(), one.xg.numpy(),
                                   rtol=0, atol=2e-5)
        np.testing.assert_allclose(out.xj[i, :nj].numpy(), one.xj.numpy(),
                                   rtol=0, atol=2e-5)
        for k in ("E_pp", "E_pq"):
            n = getattr(one, k).shape[1]
            np.testing.assert_array_equal(getattr(out, k)[i, :, :n].numpy(),
                                          getattr(one, k).numpy(), err_msg=k)
        for k, n in (("mask_g", ng), ("mask_j", nj)):
            np.testing.assert_array_equal(getattr(out, k)[i, :n].numpy(),
                                          getattr(one, k).numpy(), err_msg=k)
