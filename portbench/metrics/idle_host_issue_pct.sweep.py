"""idle_host_issue_pct.sweep: the share of the recorded stretch (portbench/
recorded.py) in which the card is idle while the host is inside spans 1
and later of a build (the port's graingnn.span), issuing the build's
later spans, in %."""

from portbench import recorded


def read(trace):
    rec = getattr(trace, "recorded", None)
    if rec is None or rec.window_s <= 0 or not rec.spans:
        return None
    return 100.0 * recorded.idle_split(rec)["host_issue"] / rec.window_s
