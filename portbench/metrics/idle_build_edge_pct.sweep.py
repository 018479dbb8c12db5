"""idle_build_edge_pct.sweep: the share of the recorded stretch (portbench/
recorded.py) in which the card is idle while the host is in the port's
graingnn.capacity_read, outside every graingnn.build, or in span 0 of a
build: the drain at a build's end and the refill after it, in %."""

from portbench import recorded


def read(trace):
    rec = getattr(trace, "recorded", None)
    if rec is None or rec.window_s <= 0 or not rec.spans:
        return None
    return 100.0 * recorded.idle_split(rec)["build_edge"] / rec.window_s
