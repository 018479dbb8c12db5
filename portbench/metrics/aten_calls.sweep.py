"""aten_calls.sweep: the aten operators the host issues in a span (those not
nested in another aten operator, inside `span` ranges), per span."""


def read(trace):
    if not trace.spans:
        return None
    return trace.span_aten_calls / trace.spans
