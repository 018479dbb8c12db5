"""device_idle_pct.sweep: the share of the device-only traced stretch in
which no operation ran on the card (the stretch less the union of the
device operations' intervals, over the stretch), in %."""


def read(trace):
    t = trace.timeline
    if t is None or t.window_s <= 0 or not t.ops:
        return None
    return 100.0 * (t.window_s - t.busy_s()) / t.window_s
