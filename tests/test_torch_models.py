"""Regressor and classifier outputs of the port against the JAX package with
the shipped checkpoints, on a generate-mode 40 um graph; and one cell step
with fresh random weights at a narrow width."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graingraphnn_torch.kernels import cell_update
from graingraphnn_torch.models import cells, grain_nn
from graingraphnn_torch.rollout import device_rollout as dr
from graingraphnn_torch.train import checkpoint
from graingraphnn_tpu.data import extraction
from graingraphnn_tpu.models import cells as jcells
from graingraphnn_tpu.models import grain_nn as jgn
from graingraphnn_tpu.models import hyper as jhyper
from graingraphnn_tpu.rollout import device_driver as jdd
from graingraphnn_tpu.rollout import device_rollout as jdr
from graingraphnn_tpu.train import checkpoint as jck
from tests.test_device_rollout import make_traj

ATOL = 1e-4
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_state(js):
    return dr.DeviceRolloutState(**{
        k: torch.from_numpy(np.array(getattr(js, k)))
        for k in ("xg", "xj", "E_pp", "E_pq", "mask_g", "mask_j", "n_pp")})


@pytest.fixture(scope="module")
def graph40():
    traj = make_traj(5)
    hg0 = extraction.make_test_sample(traj, span=6)
    js, _, _ = jdd.init_scaled_state(hg0, traj)
    jsample, _ = jax.jit(jdr.make_sample)(js)
    tsample, _ = dr.make_sample(port_state(js))
    return jsample, tsample


@pytest.mark.parametrize("name", ["regressor0", "classifier1"])
def test_shipped_model_matches_jax(graph40, name):
    jsample, tsample = graph40
    params, hp, _ = jck.load(os.path.join(REPO, "artifacts", "40um", name))
    model = checkpoint.params_from_jax(params, hp, device="cpu")
    apply = jgn.apply_regressor if hp.model_type == "regressor" \
        else jgn.apply_classifier
    ref = jax.jit(lambda p, s: apply(p, hp, s))(params, jsample)
    with torch.no_grad():
        out = model(tsample, kernels=True)
    assert sorted(out) == sorted(ref)
    for k in ref:
        assert tuple(out[k].shape) == ref[k].shape, k
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   rtol=0, atol=ATOL, err_msg=k)


def test_pgclstm_step_matches_jax_fresh_weights(graph40):
    """One warm-started cell step (non-zero h and c) with glorot weights at
    width 16."""
    jsample, tsample = graph40
    C = 16
    hp = jhyper.regressor(0, layer_size=C)
    params = jcells.init_pgclstm(jax.random.PRNGKey(7), hp.in_grain,
                                 hp.in_joint, C)
    rng = np.random.default_rng(7)
    NG, NJ = tsample.grain_x.shape[0], tsample.joint_x.shape[0]
    hc = {k: rng.normal(0, 0.5, (n, C)).astype(np.float32)
          for k, n in (("hg", NG), ("hj", NJ), ("cg", NG), ("cj", NJ))}
    jstate = ({"grain": jnp.asarray(hc["hg"]), "joint": jnp.asarray(hc["hj"])},
              {"grain": jnp.asarray(hc["cg"]), "joint": jnp.asarray(hc["cj"])})
    jh, jc = jcells.apply_pgclstm(params, jsample, jsample.grain_x,
                                  jsample.joint_x, jstate, C)
    cell = cells.PGCLSTM(hp.in_grain, hp.in_joint, C)
    flat = checkpoint._flatten(params)
    with torch.no_grad():
        for name, p in cell.named_parameters():
            p.copy_(torch.from_numpy(np.array(flat[name])))
    tstate = ({"grain": torch.from_numpy(hc["hg"]),
               "joint": torch.from_numpy(hc["hj"])},
              {"grain": torch.from_numpy(hc["cg"]),
               "joint": torch.from_numpy(hc["cj"])})
    with torch.no_grad():
        th, tc = cells.apply_pgclstm(cell, tsample, tsample.grain_x,
                                     tsample.joint_x, tstate, C,
                                     kernels=False)
    for a, b in ((th, jh), (tc, jc)):
        for k in ("grain", "joint"):
            np.testing.assert_allclose(a[k].numpy(), np.asarray(b[k]),
                                       rtol=0, atol=ATOL)


def test_zero_state_shapes(graph40):
    _, tsample = graph40
    h, c = cells.zero_state(tsample, 8)
    assert h["grain"].shape == (tsample.grain_x.shape[0], 8)
    assert c["joint"].shape == (tsample.joint_x.shape[0], 8)
    assert float(h["joint"].abs().sum()) == 0.0
    assert grain_nn.count_params(cells.PGCLSTM(11, 8, 8)) > 0


@pytest.mark.parametrize("case,calls", [("cpu", 0), ("kernels_false", 0),
                                        ("autograd", 0), ("control", 1)])
def test_fused_update_stays_off_the_cpu_and_autograd(graph40, monkeypatch,
                                                     case, calls):
    """apply_pgclstm takes the update kernel only with kernels on the
    card: on CPU tensors, with kernels and without, and under autograd it
    reaches no launch, and its outputs and gradients are the torch
    formulation's, bit for bit. On the card, autograd is kept off the
    kernel by a refusal, not a quiet fallback: "control" hands the
    kernel's wrapper the same step under autograd (the cell's biases
    require grad) and it raises before it calls the kernel."""
    _, tsample = graph40
    C = 16
    cell = cells.init_pgclstm(cells.PGCLSTM(tsample.grain_x.shape[1],
                                            tsample.joint_x.shape[1], C),
                              torch.Generator().manual_seed(3))
    rng = np.random.default_rng(3)
    NG, NJ = tsample.grain_x.shape[0], tsample.joint_x.shape[0]
    state = tuple({k: torch.from_numpy(rng.normal(0, 0.5, (n, C)).astype(
        np.float32)) for k, n in (("grain", NG), ("joint", NJ))}
        for _ in range(2))
    taken = []

    def launched(joint, grain, out_channels):
        taken.append(out_channels)
        cell_update.launches += 1
        return [cells._gate_update(*part, out_channels)
                for part in (joint, grain)]

    def kernel(*args):
        raise AssertionError("the kernel was called")

    monkeypatch.setattr(cell_update, "cell_update_cuda", launched)
    cell_update.launches = 0
    kernels = case != "kernels_false"
    grad = case in ("autograd", "control")

    def step(fn):
        cell.zero_grad()
        with torch.set_grad_enabled(grad):
            h, c = fn()
            if grad:
                sum(t.square().sum() for d in (h, c) for t in d.values()
                    ).backward()
        return h, c, {n: p.grad for n, p in cell.named_parameters()}

    def torch_formulation():
        xg, xj = cells._gate_inputs(tsample.grain_x, tsample.joint_x,
                                    state[0])
        push, connect, pull = cells._period_convs(
            cell, tsample, xg, xj, cells.NUM_GATES, C, kernels)
        h_g, c_g = cells._lstm_update(
            pull + cell.bias["grain"].reshape(-1), state[1]["grain"], C)
        h_j, c_j = cells._lstm_update(
            push + connect + cell.bias["joint"].reshape(-1),
            state[1]["joint"], C)
        return {"grain": h_g, "joint": h_j}, {"grain": c_g, "joint": c_j}

    if case == "control":
        xg, xj = cells._gate_inputs(tsample.grain_x, tsample.joint_x,
                                    state[0])
        with torch.no_grad():
            push, connect, pull = cells._period_convs(
                cell, tsample, xg, xj, cells.NUM_GATES, C, kernels)
        refused = 0
        for grad_mode in (True, False):
            with torch.set_grad_enabled(grad_mode):
                try:
                    cell_update.launch(
                        kernel, 0, ((push, connect), cell.bias["joint"],
                                    state[1]["joint"]),
                        ((pull,), cell.bias["grain"], state[1]["grain"]), C)
                except RuntimeError as e:
                    assert "no backward" in str(e) and "bias" in str(e)
                    refused += 1
                except AssertionError:
                    assert not grad_mode    # reached the kernel without grad
        assert refused == calls and cell_update.launches == 0
        return
    got = step(lambda: cells.apply_pgclstm(
        cell, tsample, tsample.grain_x, tsample.joint_x, state, C,
        kernels=kernels))
    want = step(torch_formulation)
    assert taken == [C] * calls and cell_update.launches == calls
    for a, b in zip(got[:2], want[:2]):
        for k in ("grain", "joint"):
            assert torch.equal(a[k], b[k]), k
    for n in want[2]:
        if grad:
            assert torch.equal(got[2][n], want[2][n]), n
        else:
            assert got[2][n] is None and want[2][n] is None
