"""tail_ms: host milliseconds a query spends in the filter engine's host
tail (the self time of the port's ``model.tail`` spans, one a round of
the batch / cluster / verify state machine: the candidates' sort, batch
formation, clustering and the batched verify), the mean over the traced
queries; None where no such span falls in the window (another engine,
or a program without the span)."""

from ._program import port_trace


def read(trace):
    port = port_trace(trace)
    if port is None or not trace.queries:
        return None
    lo, hi = trace.window_start_ns, trace.window_end_ns
    recs = port.spans()
    inside = [i for i, r in enumerate(recs)
              if r.end is not None and lo <= r.start < hi]
    tails = {i for i in inside if recs[i].name == "model.tail"}
    if not tails:
        return None
    ns = sum(recs[i].end - recs[i].start for i in tails)
    ns -= sum(recs[i].end - recs[i].start for i in inside
              if recs[i].parent in tails)
    return ns / 1e6 / len(trace.queries)
