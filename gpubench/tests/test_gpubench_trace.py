"""The trace's busy and idle time per card, from fixed synthetic device
operations: on two cards each card's own and their mean; on one card the
same numbers as the single timeline the readers read before cards were
told apart."""

import pytest

from gpubench.metrics import _program, device_idle_pct, model_idle_ms
from gpubench.trace import DeviceOp, Trace, TracedQuery

MS = 1_000_000

# (card, start ms, end ms) on the profiler's clock, 5 ms ahead of the host
OPS = [(0, 7, 9), (0, 8, 12), (0, 20, 26), (0, 40, 70), (0, 102, 120),
       (1, 6, 15), (1, 30, 31), (1, 33, 60), (1, 61, 64)]
OFFSET = 5 * MS


def make_trace(ops, cards):
    queries = [TracedQuery(0, 40 * MS, 0.01, 0.001,
                           [("model", 0, 10 * MS), ("hits", 10 * MS,
                                                    40 * MS)]),
               TracedQuery(45 * MS, 95 * MS, 0.02, 0.001, [])]
    spans = [[12 * MS, 18 * MS], [50 * MS, 80 * MS]]
    return Trace(queries, [DeviceOp(f"k{i}", a * MS, b * MS, card)
                           for i, (card, a, b) in enumerate(ops)],
                 0, 100 * MS, OFFSET, spans, cards)


def single_timeline(tr):
    """The busy intervals, busy seconds, idle intervals and idle gaps by
    label of one card, as one merged timeline of every operation."""
    out = []
    lo, hi = tr.window_start_ns, tr.window_end_ns
    for op in tr.ops:
        a = max(op.start_ns - tr.offset_ns, lo)
        b = min(op.end_ns - tr.offset_ns, hi)
        if b <= a:
            continue
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    busy = sum(b - a for a, b in out) / 1e9
    idle, t = [], tr.window_start_ns
    for a, b in out + [[tr.window_end_ns] * 2]:
        if a > t:
            idle.append((t, a))
        t = max(t, b)
    return out, busy, idle


def test_one_card_reads_as_one_timeline():
    tr = make_trace([o for o in OPS if o[0] == 0], 1)
    busy_iv, busy, idle = single_timeline(tr)
    assert tr.busy_intervals(0) == busy_iv
    assert tr.busy_s() == busy
    assert tr.busy_s_per_card() == [busy]
    assert tr.idle_intervals(0) == idle
    assert device_idle_pct.read(tr) == 100.0 * (1.0 - busy / tr.window_s)
    # the breakdown's idle gaps, by the span open in each gap's middle
    tr._q_starts = [q.start_ns for q in tr.queries]
    tr._s_starts = [a for a, _ in tr.scan_spans]
    want: dict[str, float] = {}
    for a, b in idle:
        lab = tr.label((a + b) // 2)
        want[lab] = want.get(lab, 0.0) + (b - a) / 1e9
    got = dict(tr.breakdown()["idle_gaps"])
    assert got == want
    # by hand: busy 2-7, 15-21, 35-65, 97-100 ms on the host clock
    assert busy_iv == [[2 * MS, 7 * MS], [15 * MS, 21 * MS],
                       [35 * MS, 65 * MS], [97 * MS, 100 * MS]]
    # idle 0-2 (model), 7-15 and 21-35 (hits, outside the scan span
    # 12-18), 65-97 (the second query, past its scan span 50-80)
    assert got == pytest.approx({"query.model": 0.002, "query.hits": 0.022,
                                 "query": 0.032})


def test_two_cards_read_each_and_their_mean():
    tr = make_trace(OPS, 2)
    one = make_trace([o for o in OPS if o[0] == 0], 1)
    # card 1: 1-10, 25-26, 28-55, 56-59 ms on the host clock
    assert tr.busy_intervals(0) == one.busy_intervals(0)
    assert tr.busy_intervals(1) == [[1 * MS, 10 * MS], [25 * MS, 26 * MS],
                                    [28 * MS, 55 * MS], [56 * MS, 59 * MS]]
    per = tr.busy_s_per_card()
    assert per == pytest.approx([0.044, 0.040])
    assert tr.busy_s() == pytest.approx(0.042)
    assert device_idle_pct.read(tr) == pytest.approx(58.0)
    # the idle gaps of the breakdown: each card's, halved; card 1 idle
    # 0-1 (model), 10-25 (scan), 26-28 (hits), 55-56 and 59-100 (scan)
    gaps = dict(tr.breakdown()["idle_gaps"])
    assert sum(gaps.values()) == pytest.approx(tr.window_s - tr.busy_s())
    assert gaps == pytest.approx({
        "query.model": (0.002 + 0.001) / 2, "query.hits": (0.022 + 0.002) / 2,
        "query": 0.032 / 2, "query.hits.scan": 0.057 / 2})
    # operations of both cards summed by name
    ops = dict(tr.breakdown()["device_ops"])
    assert sum(ops.values()) == pytest.approx(
        sum(b - a for _c, a, b in OPS) / 1e3)


class _Span:
    def __init__(self, name, start, end, parent=None):
        self.name, self.start, self.end, self.parent = (name, start, end,
                                                        parent)


class _Port:
    """The port's trace module, as ``_program`` reads it."""

    def __init__(self, spans):
        self._spans = spans

    def spans(self):
        return self._spans

    def events(self):
        return []


def test_idle_by_span_is_the_mean_over_cards(monkeypatch):
    spans = [_Span("model.tables", 0, 30 * MS),
             _Span("scan.wait", 50 * MS, 90 * MS)]
    monkeypatch.setattr(_program, "port_trace", lambda tr: _Port(spans))
    one = make_trace([o for o in OPS if o[0] == 0], 1)
    two = make_trace(OPS, 2)
    # card 0 idle: 0-2, 7-15, 21-35, 65-97 ms; card 1: 0-1, 10-25, 26-28,
    # 55-56, 59-100 ms
    assert _program.idle_by_span(one) == pytest.approx(
        {"model.tables": 0.019, "scan.wait": 0.025})
    assert _program.idle_by_span(two) == pytest.approx(
        {"model.tables": (0.019 + 0.018) / 2,
         "scan.wait": (0.025 + 0.032) / 2})
    assert model_idle_ms.read(two) == pytest.approx(
        1e3 * (0.019 + 0.018) / 2 / 2)
