"""What the readers of the program's own trace share: the spans and
counters of the port's ``utils/trace`` that fall inside the traced window
(the port records them while the harness profiles the window).  Against a
program without that module, or a window in which no operation ran on a
device (the CPU), ``port_trace`` is None and the readers return None, so
that the result line leaves their metrics out."""

from __future__ import annotations

import bisect


def port_trace(trace):
    """The port's trace module, or None where the program has none or
    the window no device operation."""
    if not trace.ops:
        return None
    try:
        from sequence_alignment_tools_tpu_torch.utils import trace as port
    except ImportError:
        return None
    return port


def counted(trace, names) -> int | None:
    """The sum of the counts inside the window whose name passes
    ``names`` (a predicate); None without the port's trace."""
    port = port_trace(trace)
    if port is None:
        return None
    lo, hi = trace.window_start_ns, trace.window_end_ns
    return sum(n for t, name, n in port.events()
               if lo <= t < hi and names(name))


def _overlap(gaps, starts, a: int, b: int) -> int:
    """ns of [a, b) inside the sorted disjoint ``gaps``."""
    total = 0
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    while i < len(gaps) and gaps[i][0] < b:
        total += max(0, min(b, gaps[i][1]) - max(a, gaps[i][0]))
        i += 1
    return total


def idle_by_span(trace) -> dict[str, float] | None:
    """{span name: device-idle seconds in its self time}: each span's
    interval less its children's, intersected with each card's idle
    intervals, the mean over the cell's cards, for the spans that open
    inside the window (so each idle moment of a card counts once, under
    the innermost span open then)."""
    port = port_trace(trace)
    if port is None:
        return None
    lo, hi = trace.window_start_ns, trace.window_end_ns
    recs = port.spans()
    inside = [i for i, r in enumerate(recs)
              if r.end is not None and lo <= r.start < hi]
    kids: dict[int, list] = {}
    for i in inside:
        kids.setdefault(recs[i].parent, []).append(recs[i])
    out: dict[str, float] = {}
    for card in range(trace.cards):
        gaps = trace.idle_intervals(card)
        starts = [a for a, _ in gaps]
        for i in inside:
            r = recs[i]
            a, end = r.start, min(r.end, hi)
            ns = 0
            for c in sorted(kids.get(i, ()), key=lambda c: c.start):
                if c.start > a:
                    ns += _overlap(gaps, starts, a, min(c.start, end))
                a = max(a, c.end)
            if end > a:
                ns += _overlap(gaps, starts, a, end)
            out[r.name] = out.get(r.name, 0.0) + ns / 1e9 / trace.cards
    return out


def idle_ms_per_query(trace, layer: str) -> float | None:
    """Mean device-idle ms a query in the self time of the spans named
    ``<layer>.*``."""
    by_span = idle_by_span(trace)
    if by_span is None or not trace.queries:
        return None
    return 1e3 * sum(s for name, s in by_span.items()
                     if name.startswith(layer + ".")) / len(trace.queries)
