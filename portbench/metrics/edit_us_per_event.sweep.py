"""edit_us_per_event.sweep: device time of the operations launched inside
the port's graingnn.edit spans (the switch probabilities and the editor
kernel) in the recorded stretch (portbench/recorded.py), over the switches,
grain eliminations and extra events its builds' counters hold, in us."""

from portbench import recorded


def read(trace):
    rec = getattr(trace, "recorded", None)
    if rec is None:
        return None
    n = recorded.events(rec)
    device = recorded.device_s_inside(rec, "graingnn.edit")
    if n <= 0 or device <= 0:
        return None
    return 1e6 * device / n
