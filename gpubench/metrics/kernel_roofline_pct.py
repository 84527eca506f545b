"""kernel_roofline_pct: the least time one card could take for the traced
queries' work (``least_seconds`` of the traffic's mix, counted from the
problem: the database, the patterns and the hits, at one card's data
sheet bandwidth) over the device time of every kernel in the window,
summed over the cell's cards, in percent.

The least time stays one card's and the kernel time is summed, so a
scan split perfectly over N cards, each card busy 1/N of one card's
time, still reads at most 100%: N cards' bandwidth is N times one
card's, and their summed kernel time is what one card's would be."""


def read(trace):
    kernel_s = sum(op.end_ns - op.start_ns
                   for op in trace.ops if op.is_kernel) / 1e9
    if not trace.queries or kernel_s <= 0:
        return None
    return 100.0 * sum(q.least_s for q in trace.queries) / kernel_s
