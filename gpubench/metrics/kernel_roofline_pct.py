"""kernel_roofline_pct: the least time the card could take for the traced
queries' work (``generate.least_seconds``, counted from the problem: the
database, the patterns and the hits, at the data sheet's bandwidth) over
the device time of every kernel in the window, in percent."""


def read(trace):
    kernel_s = sum(op.end_ns - op.start_ns
                   for op in trace.ops if op.is_kernel) / 1e9
    if not trace.queries or kernel_s <= 0:
        return None
    return 100.0 * sum(q.least_s for q in trace.queries) / kernel_s
