"""The port's permissive reader of pickled graph samples against the JAX
package's: a pickle written here with classes of a module that cannot be
imported (plain and gzipped) loads in both as attribute bags with equal
arrays, equal padded samples, and the same refusal of torch payloads."""

import gzip
import pickle
import sys
import types

import numpy as np
import pytest

from graingraphnn_torch.data import reference_io as tref
from graingraphnn_torch.graph import schema, synthetic
from graingraphnn_tpu.data import reference_io as jref

MODULE = "absent_reference_graph_datastruct"


def heterograph_pickle(path, n=2, gz=False):
    """n heterograph objects of a class from MODULE (registered only while
    pickling), with synthetic 40 um arrays and a nested trajectory object
    of another such class."""
    mod = types.ModuleType(MODULE)
    hetero = type("GrainHeterograph", (), {"__module__": MODULE})
    traj = type("graph_trajectory", (), {"__module__": MODULE})
    mod.GrainHeterograph, mod.graph_trajectory = hetero, traj
    sys.modules[MODULE] = mod
    try:
        objs = []
        for seed in range(n):
            f, e, w, m, t = synthetic.spatial_ring_arrays(40, seed=seed)
            hg = hetero()
            hg.feature_dicts, hg.edge_index_dicts = f, e
            hg.edge_weight_dicts, hg.mask, hg.target_dicts = w, m, t
            hg.edge_type = [list(et) for et in schema.EDGE_TYPES]
            hg.physical_params = {"G": 1.904, "R": 0.558, "seed": seed}
            hg.trajectory = traj()
            hg.trajectory.frames = 121
            objs.append(hg)
        data = pickle.dumps(objs if n > 1 else objs[0])
    finally:
        del sys.modules[MODULE]
    with (gzip.open if gz else open)(path, "wb") as fh:
        fh.write(data)
    return path


def same_arrays(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            same_arrays(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            same_arrays(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("gz", [False, True])
def test_unimportable_classes_load_as_in_jax(tmp_path, gz):
    path = heterograph_pickle(tmp_path / ("s.pkl.gz" if gz else "s.pkl"),
                              gz=gz)
    tl, jl = tref.load_sample_list(str(path)), jref.load_sample_list(str(path))
    assert len(tl) == len(jl) == 2
    for t, j in zip(tl, jl):
        assert isinstance(t, tref.ShimObject)
        assert t._shim_class == j._shim_class == f"{MODULE}.GrainHeterograph"
        assert t.trajectory.frames == j.trajectory.frames == 121
        assert repr(t).startswith(f"<ShimObject {MODULE}.GrainHeterograph")
        ta, ja = tref.heterograph_to_arrays(t), jref.heterograph_to_arrays(j)
        assert ta.keys() == ja.keys()
        assert ta["edge_types"] == ja["edge_types"]
        assert ta["physical_params"] == ja["physical_params"]
        for k in ("features", "edge_index", "edge_weight", "mask", "targets"):
            same_arrays(ta[k], ja[k])


def test_one_object_loads_as_a_list_of_one(tmp_path):
    path = str(heterograph_pickle(tmp_path / "one.pkl", n=1))
    tl, jl = tref.load_sample_list(path), jref.load_sample_list(path)
    assert len(tl) == len(jl) == 1
    same_arrays(tref.heterograph_to_arrays(tl[0])["features"],
                jref.heterograph_to_arrays(jl[0])["features"])


def test_padded_samples_match_jax(tmp_path):
    """heterograph_to_sample at the same capacities: every field of the
    port's GraphSample equals the JAX package's."""
    path = str(heterograph_pickle(tmp_path / "s.pkl"))
    t = tref.load_sample_list(path)[0]
    j = jref.load_sample_list(path)[0]
    caps = dict(grain_cap=48, joint_cap=96, jj_edge_cap=320)
    ts = tref.heterograph_to_sample(t, device="cpu", **caps)
    js = jref.heterograph_to_sample(j, **caps)
    names = [f for f in vars(ts) if getattr(ts, f) is not None]
    assert names
    for f in names:
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)


def test_torch_payloads_are_refused(tmp_path):
    """A pickle that names a torch class is refused by both readers."""
    path = tmp_path / "t.pkl"
    path.write_bytes(b"\x80\x04ctorch._utils\n_rebuild_tensor_v2\n.")
    for mod in (tref, jref):
        with pytest.raises(pickle.UnpicklingError, match="torch"):
            mod.load_pickle(str(path))
