"""span_host_ms.sweep: the host's time in a span, the mean duration of the
harness's `span` ranges (around the port's batched_step) over the traced
window's spans, in ms. Under the profiler, so it carries its cost."""


def read(trace):
    if not trace.span_host_s:
        return None
    return 1e3 * sum(trace.span_host_s) / len(trace.span_host_s)
