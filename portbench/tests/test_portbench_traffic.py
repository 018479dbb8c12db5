"""The traffic generator: every lane's starting graph keeps to the graph
schema, is the same for the same seed, carries the port's t = 0 features,
and the port's init_scaled_state takes it."""

import numpy as np
import pytest

from portbench import traffic

TRAFFIC = {"lanes": 3, "lxd": 40, "grain_spacing": 4, "G": 1.904,
           "R": 0.558, "span": 6}


def schema_faults(graph) -> int:
    """Junctions off the graph schema: each has three grains and three
    junction neighbours both ways, every jj edge is listed both ways once,
    and the two junctions of a jj edge share two grains."""
    x, edges = graph[0], graph[1]
    nj = len(x["joint"])
    pull, jj = edges["pull"], edges["connect"]
    bad = int((np.bincount(pull[0], minlength=nj) != 3).sum())
    for row in jj:
        bad += int((np.bincount(row, minlength=nj) != 3).sum())
    pairs = set(zip(jj[0].tolist(), jj[1].tolist()))
    bad += len(jj[0]) - len(pairs)
    bad += sum((v, u) not in pairs for u, v in pairs)
    grains = pull[1].reshape(-1, 3)
    bad += sum(len(set(grains[u]) & set(grains[v])) != 2 for u, v in pairs)
    return bad


@pytest.mark.parametrize("lxd", [40, 120, 240])
def test_every_lane_keeps_to_the_schema(lxd):
    t = dict(TRAFFIC, lxd=lxd)
    for seed in (0, 2 ** 31 + 11, 4294967301):
        graph = traffic.lane_graph(t, seed)
        assert schema_faults(graph) == 0
        ng, nj = len(graph[0]["grain"]), len(graph[0]["joint"])
        assert nj == 2 * ng                    # trivalent on a torus
        # the grains tile the domain: areas sum to its pixels over a patch's
        side = int(lxd / traffic.MESH_UM) + 1
        patch = int(round(traffic.PATCH_UM / traffic.MESH_UM)) + 1
        assert np.isclose(graph[0]["grain"][:, 3].sum(), side ** 2 / patch ** 2)
        assert abs(ng - 1.1547 * (lxd / 4) ** 2) < 0.05 * ng


def test_schema_faults_sees_a_one_way_edge():
    graph = traffic.lane_graph(TRAFFIC, 5)
    edges = dict(graph[1])
    jj = edges["connect"].copy()
    jj[:, 0] = jj[::-1, 0]
    edges["connect"] = jj
    assert schema_faults((graph[0], edges) + graph[2:]) > 0


def test_the_same_seed_gives_the_same_lanes():
    a = traffic.lane_graphs(TRAFFIC, 2 ** 31 + 3)
    b = traffic.lane_graphs(TRAFFIC, 2 ** 31 + 3)
    c = traffic.lane_graphs(TRAFFIC, 2 ** 31 + 4)
    for ga, gb in zip(a, b):
        assert np.array_equal(ga[0]["joint"], gb[0]["joint"])
        assert np.array_equal(ga[1]["connect"], gb[1]["connect"])
    assert np.array_equal(a[1][0]["joint"], c[0][0]["joint"])   # seed + i
    assert not np.array_equal(a[0][0]["joint"][:5], c[0][0]["joint"][:5])


def test_features_are_the_ports_t0_features():
    x = traffic.lane_graph(TRAFFIC, 9)[0]
    g, j = x["grain"], x["joint"]
    assert g.shape[1] == 11 and j.shape[1] == 8
    assert ((g[:, :2] >= 0) & (g[:, :2] < 1)).all()
    assert ((j[:, :2] >= 0) & (j[:, :2] < 1)).all()
    assert (g[:, [2, 4, 10]] == 0).all() and (j[:, [2, 6, 7]] == 0).all()
    assert np.allclose(g[:, 5] ** 2 + g[:, 6] ** 2, 1)
    assert np.allclose(g[:, 9], 6 / 120) and np.allclose(j[:, 5], 6 / 120)
    assert np.allclose(j[:, 3], 1 - 1.904 / 10) and np.allclose(j[:, 4],
                                                                0.558 / 2)


def test_the_port_takes_the_lanes():
    graphs = traffic.lane_graphs(dict(TRAFFIC, lxd=120, lanes=2), 17)
    start, singles = traffic.starting_state(graphs, "cpu")
    assert start.xg.shape[0] == 2 and len(singles) == 2
    assert int(singles[0].n_pp) == graphs[0][1]["connect"].shape[1]
