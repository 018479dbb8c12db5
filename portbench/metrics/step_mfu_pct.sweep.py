"""step_mfu_pct.sweep: the FLOPs of the two forwards' convs a span
(portbench/cost.py over the convs of the stretch with the ranges, live
edges as in conv_roofline_pct.sweep), times the spans of the device-only
stretch, over that stretch and the configuration's peak, in %. The LSTM
updates and the heads are not counted."""

from portbench import cost


def read(trace):
    t = trace.timeline
    if (t is None or t.window_s <= 0 or not trace.convs
            or not trace.span_edges):
        return None
    per_span = len(trace.convs) // len(trace.span_edges)
    flops = 0.0
    for i, c in enumerate(trace.convs):
        flops += cost.conv_flops(c["ns"], c["nd"],
                                 trace.span_edges[i // per_span] / 3.0,
                                 c["f_src"], c["f_dst"], c["gates"],
                                 c["channels"])
    per_span_flops = flops / len(trace.span_edges)
    return (100.0 * per_span_flops * t.spans / t.window_s
            / cost.PEAK_FLOPS[trace.precision])
