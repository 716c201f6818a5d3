"""Host milliseconds an epoch inside the program's propagation spans:
the per-step (and, on the blocked arm, per-block) Python and enqueue."""


def read(run):
    host_s = run.trace.span_host_s(run.propagate_spans)
    if host_s <= 0:
        return None
    return 1e3 * host_s / run.units
