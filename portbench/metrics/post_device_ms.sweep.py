"""post_device_ms.sweep: device time of the operations launched inside the
`post` ranges (the port's post_forward_step) and outside its `edit`
range: integration, the elimination candidates, compaction and the
grain centers, per span, in ms."""


def read(trace):
    if not trace.spans:
        return None
    return 1e3 * trace.device_s(inside="post", outside="edit") / trace.spans
