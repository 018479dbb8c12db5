"""forward_device_ms.sweep: device time of the operations launched inside
the `forward` ranges (the regressor's and the classifier's forwards, the
conv kernels included), per span, in ms."""


def read(trace):
    if not trace.spans:
        return None
    return 1e3 * trace.device_s(inside="forward") / trace.spans
