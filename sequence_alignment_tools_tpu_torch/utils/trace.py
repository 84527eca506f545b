"""The port's spans and counters, and its route lines.

- :func:`span` times a block of the port on the host clock
  (``time.perf_counter_ns``).  A record holds the block's name
  (``layer.phase``), start and end, the index of the span it opened
  inside (-1 for none) and a request id: the id a model passes
  (:func:`new_request`, one per ``PrimerMatchModel``), or else its
  parent's.  Records stay in memory, in the order they opened, and are
  read with :func:`spans`.
- :func:`count` adds to a named total, always (:func:`total`); while
  recording it also keeps the event ``(t_ns, name, n)`` (:func:`events`),
  so that a count can be placed in the request it fell in.
- :func:`route` prints a scanner's route line once.

Recording is on exactly while a ``torch.profiler`` session records
(``torch.autograd.profiler._is_profiler_enabled``): an operator who
profiles the port gets its spans, and nothing else turns them on.  This
module imports no torch; until torch is imported, nothing records.  Off,
a span costs the check and a shared null context: no allocation and no
clock read.

The names in use:

- spans: ``io.pattern_set``; ``model.init``, ``model.tables``,
  ``model.gate``, ``model.extend``, ``model.dedup``, ``model.emit``,
  ``model.tail`` (a round of the filter engine's batch / cluster / verify
  tail), ``model.hits``, ``model.close``; ``scan.tables``, ``scan.upload``,
  ``scan.dispatch``, ``scan.wait``, ``scan.decode``, ``scan.redispatch``;
- counters: ``launch.<wrapper>`` per kernel launch of the six CUDA
  wrappers; ``scan.positions``, the text positions each call of a
  text-scanning kernel covers (``scan_occupancy``, ``scan_slots``,
  ``myers_pairs``, and ``sellers_scan`` per block of patterns; on the CPU
  their plain versions); ``scan.rescore_retry``, each overflow retry of
  the fused route served from a kept filter occupancy (the rescore
  alone); ``scan.blocks``, the blocks of a k-edit scan past
  ``SellersScanner._KEDIT_BLOCK`` positions; ``census.prefix_in`` and
  ``census.prefix_ok``, the census candidates of patterns keyed by a
  prefix (longer than the register holds) handed to the host verify and
  those it keeps (``ConvScanner._verify_prefix``); ``upload.bytes``, the
  bytes of text and tables put on a scanner's device; ``cand.extend_in`` and
  ``cand.extend_ok``, the seed candidates handed to the host extension and
  those that extend; ``cand.verify_in`` and ``cand.verify_ok``, the
  filter engine's clusters handed to the verify and those it keeps.
"""

from __future__ import annotations

import itertools
import os
import sys
import threading
import time


class SpanRecord:
    __slots__ = ("name", "start", "end", "parent", "request")

    def __init__(self, name, start, parent, request):
        self.name = name
        self.start = start
        self.end = None
        self.parent = parent
        self.request = request


_records: list[SpanRecord] = []
_events: list[tuple[int, str, int]] = []
_totals: dict[str, int] = {}
_lock = threading.Lock()
_local = threading.local()   # .top: index of the innermost open span
_requests = itertools.count(1)
_profiler = None             # torch.autograd.profiler, once imported


def recording() -> bool:
    """Whether a ``torch.profiler`` session records now."""
    global _profiler
    if _profiler is None:
        _profiler = sys.modules.get("torch.autograd.profiler")
        if _profiler is None:
            return False
    return _profiler._is_profiler_enabled


class _Null:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_NULL = _Null()


class _Span:
    __slots__ = ("name", "request", "rec")

    def __init__(self, name, request):
        self.name = name
        self.request = request

    def __enter__(self):
        parent = getattr(_local, "top", -1)
        req = self.request
        if req is None and parent >= 0:
            req = _records[parent].request
        rec = SpanRecord(self.name, time.perf_counter_ns(), parent, req)
        with _lock:
            _local.top = len(_records)
            _records.append(rec)
        self.rec = rec
        return rec

    def __exit__(self, *exc):
        rec = self.rec
        rec.end = time.perf_counter_ns()
        _local.top = rec.parent
        return False


def span(name: str, request: int | None = None):
    """A context manager that records the block it holds as ``name``
    while recording is on (see the module's notes)."""
    if not recording():
        return _NULL
    return _Span(name, request)


def new_request() -> int:
    """A fresh request id."""
    return next(_requests)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the total ``name``; while recording, keep the event."""
    _totals[name] = _totals.get(name, 0) + n
    if recording():
        _events.append((time.perf_counter_ns(), name, n))


def spans() -> list[SpanRecord]:
    """Every span recorded, in the order they opened (the list itself)."""
    return _records


def events() -> list[tuple[int, str, int]]:
    """Every ``(t_ns, name, n)`` counted while recording (the list
    itself)."""
    return _events


def total(name: str) -> int:
    """The counter ``name``'s total since the process started."""
    return _totals.get(name, 0)


def route(owner, msg: str) -> None:
    """Name the route ``owner`` (a scanner) takes, once per owner, as a
    '-v' line (``owner.progress`` set, or SAT_ROUTE_VERBOSE=1)."""
    if owner.progress is None and not os.environ.get("SAT_ROUTE_VERBOSE"):
        return
    if owner._routes_done is None:
        owner._routes_done = set()
    if msg in owner._routes_done:
        return
    owner._routes_done.add(msg)
    from .log import timestamp

    timestamp("Route: " + msg)
