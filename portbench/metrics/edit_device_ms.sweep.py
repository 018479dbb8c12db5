"""edit_device_ms.sweep: device time of the operations launched inside the
`edit` ranges (the port's edit_stage: the switch probabilities and the
editor kernel), per span, in ms."""


def read(trace):
    if not trace.spans:
        return None
    return 1e3 * trace.device_s(inside="edit") / trace.spans
