"""The port's config, checkpoint loading and JAX parameter mapping against
the JAX package, and the port's independence from JAX."""

import dataclasses
import datetime
import io
import os
import pickle
import subprocess
import sys

import jax
import numpy as np
import pytest

from graingraphnn_torch.models import grain_nn, hyper
from graingraphnn_torch.train import checkpoint
from graingraphnn_tpu.models import grain_nn as jgn
from graingraphnn_tpu.models import hyper as jhyper
from graingraphnn_tpu.train import checkpoint as jck

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = ["regressor0", "classifier1"]


def _flat(tree):
    return {k: np.asarray(v) for k, v in checkpoint._flatten(tree).items()}


def test_regressor_param_count_matches_reference():
    model = grain_nn.build(hyper.regressor(0))
    assert grain_nn.count_params(model) == 1_204_612


def test_classifier_param_count_matches_reference():
    model = grain_nn.build(hyper.classifier_transfered(1))
    assert grain_nn.count_params(model) == 1_204_806


@pytest.mark.parametrize("make", ["regressor", "classifier",
                                  "classifier_transfered"])
@pytest.mark.parametrize("model_id", [0, 1, 5, 17])
def test_hyper_decode_matches_jax(make, model_id):
    ours = getattr(hyper, make)(model_id)
    theirs = getattr(jhyper, make)(model_id)
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    assert ours.cell_kinds == theirs.cell_kinds


@pytest.mark.parametrize("name", SHIPPED)
def test_load_matches_jax_loader(name):
    path = os.path.join(REPO, "artifacts", "40um", name)
    tree, hp, extra = checkpoint.load(path)
    jtree, jhp, jextra = jck.load(path)
    assert dataclasses.asdict(hp) == dataclasses.asdict(jhp)
    assert extra == jextra
    ours, theirs = _flat(tree), _flat(jtree)
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        assert ours[k].dtype == np.float32
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


@pytest.mark.parametrize("name", SHIPPED)
def test_params_from_jax_round_trips_shipped(name):
    jtree, hp, _ = jck.load(os.path.join(REPO, "artifacts", "40um", name))
    model = checkpoint.params_from_jax(jtree, hp, device="cpu")
    back = checkpoint.params_to_jax(model)
    assert isinstance(back["encoder"], list) and len(back["encoder"]) == 1
    ours, theirs = _flat(back), _flat(jtree)
    assert sorted(ours) == sorted(theirs)
    for k in theirs:
        np.testing.assert_array_equal(ours[k], theirs[k], err_msg=k)


def test_params_from_jax_round_trips_fresh_init():
    hp_r = jhyper.regressor(0, layer_size=16)
    hp_c = jhyper.classifier_transfered(1, layer_size=16)
    rp = jgn.init_regressor(jax.random.PRNGKey(3), hp_r)
    cp = jgn.init_classifier(jax.random.PRNGKey(4), hp_c)
    for tree, hp in ((rp, hp_r), (cp, hp_c)):
        model = checkpoint.params_from_jax(tree, hp, device="cpu")
        assert grain_nn.count_params(model) == jgn.count_params(tree)
        back = _flat(checkpoint.params_to_jax(model))
        for k, v in _flat(tree).items():
            np.testing.assert_array_equal(back[k], v, err_msg=k)


def test_params_from_jax_rejects_a_tree_that_does_not_fit():
    jtree, hp, _ = jck.load(os.path.join(REPO, "artifacts", "40um",
                                         "regressor0"))
    missing = dict(jtree, head={"grain": jtree["head"]["grain"]})
    with pytest.raises(ValueError, match="parameter trees differ"):
        checkpoint.params_from_jax(missing, hp, device="cpu")
    wrong = dict(jtree, head={"grain": jtree["head"]["grain"],
                              "joint": {"w": np.zeros((3, 2), np.float32),
                                        "b": jtree["head"]["joint"]["b"]}})
    with pytest.raises(ValueError, match="head.joint.w"):
        checkpoint.params_from_jax(wrong, hp, device="cpu")


def test_unpickler_maps_numpy_core_and_refuses_other_modules():
    u = checkpoint._NumpyUnpickler(io.BytesIO(b""))
    assert u.find_class("numpy._core.multiarray", "_reconstruct") is not None
    evil = pickle.dumps(datetime.date(2020, 1, 1))
    with pytest.raises(pickle.UnpicklingError):
        checkpoint._NumpyUnpickler(io.BytesIO(evil)).load()


def test_package_imports_neither_jax_nor_the_jax_package():
    code = (
        "import pkgutil, importlib, sys, graingraphnn_torch\n"
        "for m in pkgutil.walk_packages(graingraphnn_torch.__path__,\n"
        "                               'graingraphnn_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'jaxlib', 'flax', 'optax', 'graingraphnn_tpu')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules\n"
        "           if m.startswith('graingraphnn_torch')]))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_unsupported_configs_raise():
    """An unknown model type raises. The configs the port refused before
    training was ported (layers=2, history, edge_len) now build, with the
    JAX package's parameter tree."""
    with pytest.raises(ValueError, match="model_type"):
        grain_nn.build(dataclasses.replace(hyper.regressor(0),
                                           model_type="gnn"))
    for kw in ({"layers": 2}, {"history": True}, {"edge_len": True}):
        hp = hyper.regressor(0, **kw)
        shapes = jax.eval_shape(lambda k: jgn.init_regressor(k, hp),
                                jax.random.PRNGKey(0))
        want = {k: tuple(v.shape) for k, v in checkpoint._flatten(shapes).items()}
        got = {k: tuple(v.shape) for k, v in
               grain_nn.build(hp).named_parameters()}
        assert got == want, kw
