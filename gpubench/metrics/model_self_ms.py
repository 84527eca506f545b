"""model_self_ms: host milliseconds a query spends in the model layer
(``models/primer_match``: engine choice, table and gate builds, host tail
and extension, final alignment), outside the scanners' ``scan*`` calls:
the mean over the traced queries of query wall minus scanner time."""


def read(trace):
    if not trace.queries:
        return None
    return 1e3 * sum(q.wall_s - q.scan_s for q in trace.queries) \
        / len(trace.queries)
