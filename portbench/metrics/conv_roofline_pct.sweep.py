"""conv_roofline_pct.sweep: the convs' least time (portbench/cost.py: the
larger of the function's FLOPs over the precision's peak and its inputs
and output over the HBM's bandwidth, per call) over the device time of
every operation launched inside the `conv` ranges, in %.

A call's live edges are a third of its span's message edges: every live
junction has three grain and three junction neighbours, so push, pull and
connect each hold the same number of live edges."""

from portbench import cost


def read(trace):
    device = trace.device_s(inside="conv")
    if device <= 0 or not trace.convs or not trace.span_edges:
        return None
    per_span = len(trace.convs) // len(trace.span_edges)
    least = 0.0
    for i, c in enumerate(trace.convs):
        edges = trace.span_edges[i // per_span] / 3.0
        least += cost.conv_least_s(c["ns"], c["nd"], c["k"], edges,
                                   c["f_src"], c["f_dst"], c["gates"],
                                   c["channels"], trace.precision)
    return 100.0 * least / device
