"""The port's plain PeriodConv (the CUDA edge-stage kernel's oracle) against
the JAX package's XLA formulation and its Pallas kernel run in interpret
mode with f32 operands. Inputs are numpy draws from a seed: positions in
the unit square, so many edges wrap across the periodic boundary, and
some destination rows fully masked."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graingraphnn_torch.ops import period_conv as tpc
from graingraphnn_torch.ops import segment
from graingraphnn_tpu.kernels.edge_stage import apply_period_conv_pallas
from graingraphnn_tpu.ops import period_conv as jpc
from graingraphnn_tpu.ops import segment as jseg

ATOL = 2e-5   # fp32, the same sums in another order


def _case(seed, G, C, K, Ns=23, Nd=19, Fs=11, Fd=8):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    GC = G * C

    def dense(fan_in):
        return {"w": rng.normal(0, 0.3, (fan_in, GC)).astype(f32),
                "b": rng.normal(0, 0.1, GC).astype(f32)}

    params = {
        "key": dense(Fs), "query": dense(Fd), "value": dense(Fs),
        "skip": dense(Fd),
        "l2": {"w": rng.normal(0, 0.3, (G, C, C)).astype(f32),
               "b": rng.normal(0, 0.1, (G, C)).astype(f32)},
        "edge": {"w": rng.normal(0, 0.3, GC).astype(f32)},
    }
    x_src = rng.uniform(0, 1, (Ns, Fs)).astype(f32)
    x_dst = rng.uniform(0, 1, (Nd, Fd)).astype(f32)
    nbr = rng.integers(0, Ns, (Nd, K)).astype(np.int32)
    elen = rng.uniform(0.0, 0.3, (Nd, K)).astype(f32)
    mask = (rng.uniform(size=(Nd, K)) < 0.7).astype(f32)
    mask[::5] = 0.0                                  # fully masked rows
    rel = x_src[nbr][..., :3] - x_dst[:, None, :3]
    assert (np.abs(rel) > 0.5).any()                 # wrapping edges
    return params, x_src, x_dst, nbr, elen, mask


def _conv(params, Fs, Fd, G, C):
    conv = tpc.PeriodConv(Fs, Fd, C, G)
    with torch.no_grad():
        for name, p in conv.named_parameters():
            mod, leaf = name.split(".")
            p.copy_(torch.from_numpy(params[mod][leaf]))
    return conv


def _port(case, G, C):
    params, xs, xd, nbr, elen, mask = case
    conv = _conv(params, xs.shape[1], xd.shape[1], G, C)
    with torch.no_grad():
        out = tpc.apply_period_conv(
            conv, torch.from_numpy(xs), torch.from_numpy(xd),
            torch.from_numpy(nbr), torch.from_numpy(elen),
            torch.from_numpy(mask), num_gates=G, out_channels=C,
            kernels=False)
    return out.numpy()


@pytest.mark.parametrize("G,C,K", [(1, 8, 3), (4, 8, 3), (1, 8, 16),
                                   (4, 8, 16), (4, 16, 16)])
def test_plain_conv_matches_jax(G, C, K):
    case = _case(G * 100 + K, G, C, K)
    params, xs, xd, nbr, elen, mask = case
    ref = jpc.apply_period_conv(
        params, jnp.asarray(xs), jnp.asarray(xd), jnp.asarray(nbr),
        jnp.asarray(elen), jnp.asarray(mask), num_gates=G, out_channels=C)
    out = _port(case, G, C)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=0, atol=ATOL)
    # a fully masked row is the skip projection alone
    skip = xd[0] @ params["skip"]["w"] + params["skip"]["b"]
    np.testing.assert_allclose(out[0], skip, rtol=0, atol=ATOL)


@pytest.mark.parametrize("K,flat", [(3, False), (3, True), (16, False),
                                    (16, True)])
def test_plain_conv_matches_pallas_interpret_f32(K, flat):
    G, C = 4, 8
    case = _case(7 + K, G, C, K, Ns=21, Nd=13)
    params, xs, xd, nbr, elen, mask = case
    ref = apply_period_conv_pallas(
        params, jnp.asarray(xs), jnp.asarray(xd), jnp.asarray(nbr),
        jnp.asarray(elen), jnp.asarray(mask), num_gates=G, out_channels=C,
        interpret=True, compute_dtype=jnp.float32, flat=flat)
    np.testing.assert_allclose(_port(case, G, C), np.asarray(ref), rtol=0,
                               atol=ATOL)


def test_masked_softmax_matches_jax_with_empty_rows():
    rng = np.random.default_rng(0)
    logits = rng.normal(0, 3, (9, 16, 4)).astype(np.float32)
    mask = (rng.uniform(size=(9, 16, 1)) < 0.5).astype(np.float32)
    mask[2] = 0.0
    ref = np.asarray(jseg.masked_softmax(jnp.asarray(logits),
                                         jnp.asarray(mask), axis=1))
    out = segment.masked_softmax(torch.from_numpy(logits),
                                 torch.from_numpy(mask), dim=1).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    assert np.all(out[2] == 0.0) and np.isfinite(out).all()


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel wrapper never computes on the CPU: plain versions are
    reached only through the dispatch, for CPU tensors."""
    params, xs, xd, nbr, elen, mask = _case(1, 4, 8, 3)
    conv = _conv(params, xs.shape[1], xd.shape[1], 4, 8)
    from graingraphnn_torch.kernels import edge_stage
    with torch.no_grad(), pytest.raises(ValueError, match="on cpu"):
        edge_stage.apply_period_conv_cuda(
            conv, torch.from_numpy(xs), torch.from_numpy(xd),
            torch.from_numpy(nbr), torch.from_numpy(elen),
            torch.from_numpy(mask), num_gates=4, out_channels=8)


def test_geometry_matches_jax():
    from graingraphnn_torch.graph import geometry as tg
    from graingraphnn_tpu.graph import geometry as jg

    rng = np.random.default_rng(5)
    p = rng.uniform(0, 1, (64, 2)).astype(np.float32)
    pc = rng.uniform(0, 1, (64, 2)).astype(np.float32)
    rel = p - pc
    for name, args in (("wrap_shift", (rel,)), ("min_image", (rel,)),
                       ("periodic_dist", (p, pc))):
        ref = getattr(jg, name)(*map(jnp.asarray, args))
        out = getattr(tg, name)(*map(torch.from_numpy, args))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                                   atol=1e-7, err_msg=name)
