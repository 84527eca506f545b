"""The traced run's instruments, all outside the program: a
``torch.profiler`` session over the window, and host-clock spans around
the calls into the program's layers.

- :class:`ScanSpans` wraps the public ``scan*`` methods of the port's
  scanners (``ConvScanner``, ``SellersScanner``), timing the outermost
  call and, where a method is a generator, each resumption of it.
- :class:`Trace` holds what a per-layer metric reads (``metrics/*.py``):
  each traced query's wall and scanner seconds and least time, and the
  devices' operations from the profiler (kernels, copies, sets), each on
  its card, with each card's busy time and idle gaps, their mean over the
  cell's cards, and what the host was doing in each gap.

Host spans use ``time.perf_counter_ns``; one ``record_function`` range
per query ties that clock to the profiler's.
"""

from __future__ import annotations

import bisect
import inspect
import statistics
import time
from dataclasses import dataclass, field

QUERY_RANGE = "gpubench.query"


class ScanSpans:
    """Host-clock intervals inside the scanners, while installed."""

    def __init__(self):
        self.depth = 0
        self.spans: list[list[int]] = []   # [start ns, end ns], merged
        self._saved = []

    def _add(self, t0: int, t1: int) -> None:
        if self.spans and t0 - self.spans[-1][1] < 20_000:
            self.spans[-1][1] = t1
        else:
            self.spans.append([t0, t1])

    def _timed_gen(self, gen):
        while True:
            self.depth += 1
            t0 = time.perf_counter_ns()
            try:
                item = next(gen)
            except StopIteration:
                return
            finally:
                self.depth -= 1
                self._add(t0, time.perf_counter_ns())
            yield item

    def _wrap(self, fn):
        def call(*a, **kw):
            if self.depth:
                return fn(*a, **kw)
            self.depth += 1
            t0 = time.perf_counter_ns()
            try:
                out = fn(*a, **kw)
            finally:
                self.depth -= 1
                self._add(t0, time.perf_counter_ns())
            return self._timed_gen(out) if inspect.isgenerator(out) else out
        return call

    def install(self) -> None:
        from sequence_alignment_tools_tpu_torch.ops.conv_scan import (
            ConvScanner,
        )
        from sequence_alignment_tools_tpu_torch.ops.sellers import (
            SellersScanner,
        )

        for cls in (ConvScanner, SellersScanner):
            for name, fn in list(vars(cls).items()):
                if name.startswith("scan") and inspect.isfunction(fn):
                    self._saved.append((cls, name, fn))
                    setattr(cls, name, self._wrap(fn))

    def remove(self) -> None:
        for cls, name, fn in self._saved:
            setattr(cls, name, fn)
        self._saved = []

    def seconds_within(self, t0: int, t1: int, since: int = 0) -> float:
        """Seconds of the spans from index ``since`` on inside [t0, t1)."""
        return sum(max(0, min(b, t1) - max(a, t0))
                   for a, b in self.spans[since:]) / 1e9


@dataclass
class TracedQuery:
    start_ns: int
    end_ns: int
    scan_s: float
    least_s: float
    phases: list = field(default_factory=list)  # (name, start ns, end ns)

    @property
    def wall_s(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


@dataclass
class DeviceOp:
    name: str
    start_ns: int
    end_ns: int
    card: int = 0           # the CUDA device index it ran on

    @property
    def is_kernel(self) -> bool:
        low = self.name.lower()
        return not (low.startswith("memcpy") or low.startswith("memset"))


def _ns(ev, what: str) -> int:
    f = getattr(ev, what + "_ns", None)
    if f is not None:
        return int(f())
    return int(getattr(ev, what + "_us")() * 1000)


def profiler_events(prof):
    """(device operations, [(range name, start ns)] of the CPU ranges
    named ``QUERY_RANGE``) from the profiler's raw events."""
    from torch.autograd import DeviceType

    ops, ranges = [], []
    for ev in prof.profiler.kineto_results.events():
        start = _ns(ev, "start")
        if ev.name().startswith("gpubench."):
            # the harness's own ranges, on the host and (as the span of
            # the device work inside them) on the device: no operation
            if ev.device_type() != DeviceType.CUDA and ev.name() == QUERY_RANGE:
                ranges.append(start)
            continue
        if ev.device_type() == DeviceType.CUDA:
            ops.append(DeviceOp(ev.name(), start,
                                start + _ns(ev, "duration"),
                                int(ev.device_index())))
    ops.sort(key=lambda o: o.start_ns)
    return ops, ranges


@dataclass
class Trace:
    """A traced window: queries on the host clock, device operations on
    the profiler's, and the offset between the two clocks.  ``cards`` is
    the number of the cell's cards (CUDA devices 0 .. cards - 1): busy
    time, idle time and idle gaps are each card's, and their mean over
    the cards where one number is read."""

    queries: list[TracedQuery]
    ops: list[DeviceOp]
    window_start_ns: int
    window_end_ns: int
    offset_ns: int          # profiler time = host time + offset
    scan_spans: list
    cards: int = 1

    @property
    def window_s(self) -> float:
        return (self.window_end_ns - self.window_start_ns) / 1e9

    def busy_intervals(self, card: int = 0):
        """Merged intervals of ``card``'s operations, on the host clock,
        clipped to the window."""
        out = []
        lo, hi = self.window_start_ns, self.window_end_ns
        for op in self.ops:
            if op.card != card:
                continue
            a = max(op.start_ns - self.offset_ns, lo)
            b = min(op.end_ns - self.offset_ns, hi)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s_per_card(self) -> list[float]:
        return [sum(b - a for a, b in self.busy_intervals(c)) / 1e9
                for c in range(self.cards)]

    def busy_s(self) -> float:
        """Seconds in which an operation ran, the mean over the cards."""
        return sum(self.busy_s_per_card()) / self.cards

    def idle_intervals(self, card: int = 0):
        """[(start, end)] host ns of the window with nothing on
        ``card``."""
        out, t = [], self.window_start_ns
        for a, b in self.busy_intervals(card) + [[self.window_end_ns] * 2]:
            if a > t:
                out.append((t, a))
            t = max(t, b)
        return out

    def label(self, t: int) -> str:
        """The innermost harness span open at host time ``t``."""
        i = bisect.bisect_right(self._q_starts, t) - 1
        if i < 0 or t >= self.queries[i].end_ns:
            return "client"
        j = bisect.bisect_right(self._s_starts, t) - 1
        if j >= 0 and t < self.scan_spans[j][1]:
            return "query.hits.scan"
        for name, a, b in self.queries[i].phases:
            if a <= t < b:
                return "query." + name
        return "query"

    def breakdown(self) -> dict:
        """The device operations that took most time, by name (summed
        over the cards), and the idle seconds by the harness span open at
        the time (the mean over the cards), largest first (at most 10 of
        each)."""
        self._q_starts = [q.start_ns for q in self.queries]
        self._s_starts = [a for a, _ in self.scan_spans]
        by_name: dict[str, float] = {}
        for op in self.ops:
            by_name[op.name] = by_name.get(op.name, 0.0) \
                + (op.end_ns - op.start_ns) / 1e9
        idle: dict[str, float] = {}
        for card in range(self.cards):
            for a, b in self.idle_intervals(card):
                lab = self.label((a + b) // 2)
                idle[lab] = idle.get(lab, 0.0) + (b - a) / 1e9 / self.cards
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[n, s] for n, s in top],
                "idle_gaps": [[n, s] for n, s in gaps]}


def clock_offset(query_starts_host: list[int], range_starts: list[int]):
    """Profiler time minus host time, from the per-query ranges."""
    pairs = list(zip(sorted(range_starts), query_starts_host))
    if not pairs:
        return 0
    return int(statistics.median(r - h for r, h in pairs))
