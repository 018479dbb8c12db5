"""No module of the benchmark imports JAX or the JAX package, and the
reference imports nothing of the port, by whole top-level names."""

import ast
import os

import pytest

from portbench import spec

JAX = {"jax", "jaxlib", "flax", "graingraphnn_tpu"}


def modules():
    for base, _dirs, files in os.walk(spec.HERE):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def top_level_imports(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(modules()),
                         ids=lambda p: os.path.relpath(p, spec.HERE))
def test_no_jax(path):
    assert not top_level_imports(path) & JAX


@pytest.mark.parametrize(
    "path", sorted(p for p in modules()
                   if os.sep + "reference" + os.sep in p),
    ids=lambda p: os.path.relpath(p, spec.HERE))
def test_reference_imports_nothing_of_the_port(path):
    assert "graingraphnn_torch" not in top_level_imports(path)
    assert "portbench" not in top_level_imports(path)


def test_whole_names_are_compared():
    assert "graingraphnn_torch".split(".")[0] not in JAX
