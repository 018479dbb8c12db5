"""The port's data/thermal against the JAX package's: the temporal (G, R)
schedule, the random Fourier series behind it, the melt-pool distance
profiles, the generate config and the span calibration grid. numpy and
scipy on both sides, so every output is equal."""

import numpy as np
import pytest

from graingraphnn_torch.data import thermal as tth
from graingraphnn_tpu.data import thermal as jth


@pytest.mark.parametrize("seed,span,counts", [(5, 6, 20), (3, 6, 1),
                                              (10020, 12, 9), (7, 8, 5)])
def test_gr_sequence_from_time_matches_jax(seed, span, counts):
    """The engine's call: freq 2^(seed % 10), dz = 0.4 span, one (G, R)
    per span from the initial height 2 to 2 + 0.4 span counts."""
    args = (seed, 2 ** (seed % 10), 0.4 * span, counts, 2.0,
            2.0 + 0.4 * span * counts)
    g, r = tth.gr_sequence_from_time(*args)
    jg, jr = jth.gr_sequence_from_time(*args)
    np.testing.assert_array_equal(g, jg)
    np.testing.assert_array_equal(r, jr)
    assert len(g) == counts
    assert (g >= 0.5).all() and (g <= 10).all()
    assert (r >= 0.2).all() and (r <= 2).all()


def test_rand_gr_matches_jax():
    t = np.linspace(0, 240.0, 501)
    np.random.seed(4)
    g, r = tth.ThermalProfile.rand_gr(t, 240.0, 16)
    np.random.seed(4)
    jg, jr = jth.ThermalProfile.rand_gr(t, 240.0, 16)
    np.testing.assert_array_equal(g, jg)
    np.testing.assert_array_equal(r, jr)
    assert g.min() == 0.5 and g.max() == 10.0


@pytest.mark.parametrize("profile", ["uniform", "line", "cylinder",
                                     "sphere4", "sphere8"])
def test_profiles_match_jax(profile):
    rng = np.random.default_rng(0)
    x, y, z = rng.uniform(0, 40, (3, 64))
    kw = dict(z0=2.0, r0=20.0)
    tp = tth.ThermalProfile((40, 40, 48), (4.0, 1.0, 0.5), seed=1)
    jp = jth.ThermalProfile((40, 40, 48), (4.0, 1.0, 0.5), seed=1)
    np.testing.assert_array_equal(tp.dist_to_interface(profile, x, y, z, **kw),
                                  jp.dist_to_interface(profile, x, y, z, **kw))
    np.testing.assert_array_equal(
        tp.pointwise_temp_const_gr(profile, x, y, z, 1e-6, **kw),
        jp.pointwise_temp_const_gr(profile, x, y, z, 1e-6, **kw))


def test_unknown_profile_raises():
    with pytest.raises(KeyError):
        tth.ThermalProfile((40, 40, 48), (4.0, 1.0, 0.5)).dist_to_interface(
            "cone", 0.0, 0.0, 0.0)


def test_generate_config_and_span_grid_match_jax():
    assert tth.default_generate_config() == jth.default_generate_config()
    entries = [(0.5, 0.2, 6), (10.0, 2.0, 24), (4.0, 1.0, 12),
               (1.904, 0.558, 6), (8.0, 0.4, 15)]
    grid = tth.build_gr_grid(entries)
    assert grid == jth.build_gr_grid(entries)
    for G, R in ((1.9, 0.56), (9.0, 1.9), (4.2, 1.1), (0.6, 0.3)):
        assert tth.span_from_gr_grid(grid, G, R) == jth.span_from_gr_grid(
            grid, G, R)
