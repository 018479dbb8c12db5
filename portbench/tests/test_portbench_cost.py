"""portbench/cost.py against the port's analytic conv count and against the
bytes of the function's inputs and output worked out by hand."""

import pytest

from graingraphnn_torch.utils import profiling
from portbench import cost

C, G = 96, 4
NG, NJ, RING = 1043, 2086, 16
# (ns, nd, k, f_src, f_dst): the 120 um graph's push, connect and pull
CONVS = {"push": (NG, NJ, 3, 11 + C, 8 + C),
         "connect": (NJ, NJ, 3, 8 + C, 8 + C),
         "pull": (NJ, NG, RING, 8 + C, 11 + C)}


@pytest.mark.parametrize("name", sorted(CONVS))
def test_flops_are_the_port_counts(name):
    ns, nd, k, fs, fd = CONVS[name]
    want = profiling.conv_cost(ns, nd, k, fs, fd, G, C)["flops"]
    assert cost.conv_flops(ns, nd, nd * k, fs, fd, G, C) == want


@pytest.mark.parametrize("precision,wb", [("fp32", 4), ("bf16", 2)])
def test_bytes_are_inputs_and_output(precision, wb):
    ns, nd, k, fs, fd = CONVS["push"]
    gc = G * C
    x = (1043 * 107 + 2086 * 104) * 4
    tables = 2086 * 3 * 4 * 3                   # nbr, length, mask
    w = (107 * gc * 2 + 104 * gc * 2            # key, value, query, skip
         + gc * 4 + G * C * C + G * C + gc)     # biases, l2, l2 bias, edge
    out = 2086 * gc * 4
    assert cost.conv_bytes(ns, nd, k, fs, fd, G, C, precision) == (
        x + tables + w * wb + out)


def test_least_time_is_the_larger_bound():
    ns, nd, k, fs, fd = CONVS["pull"]
    edges = 6 * nd
    t = cost.conv_least_s(ns, nd, k, edges, fs, fd, G, C, "bf16")
    assert t == max(cost.conv_flops(ns, nd, edges, fs, fd, G, C) / 989e12,
                    cost.conv_bytes(ns, nd, k, fs, fd, G, C, "bf16")
                    / 3.35e12)
