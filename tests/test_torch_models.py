"""Regressor and classifier outputs of the port against the JAX package with
the shipped checkpoints, on a generate-mode 40 um graph; and one cell step
with fresh random weights at a narrow width."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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
