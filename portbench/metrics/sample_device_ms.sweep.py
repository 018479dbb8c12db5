"""sample_device_ms.sweep: device time of the operations launched inside the
`sample` ranges (the port's _pack_build_sample: lengths and the three ELL
builds), per span, in ms."""


def read(trace):
    if not trace.spans:
        return None
    return 1e3 * trace.device_s(inside="sample") / trace.spans
