"""Timestamped stderr logging — the reference's observability protocol.

Replicates the ``timestamp*`` macro family (util.h:55-61): every line is
``[<asctime>] <message>`` on stderr, where asctime is the fixed 24-char
``Www Mmm dd hh:mm:ss yyyy`` local time rendering, and the numeric
variants format with printf ``%ld``/``%d``/``%g`` semantics.  ``tic``/
``toc`` (util.h:63-66) and the throttled scan progress reporter
(pattern_match.h:135-155) live here too.

The port's copy of ``sequence_alignment_tools_tpu/utils/log.py``, kept
byte-compatible with it (the port imports nothing of the JAX package).
"""

from __future__ import annotations

import sys
import time

_tictoc = 0.0


def timestamp(msg: str, stream=None) -> None:
    s = time.asctime(time.localtime())
    (stream or sys.stderr).write("[%24.24s] %s\n" % (s, msg))


def timestamp_int(msg: str, v: int, stream=None) -> None:
    """timestampli / timestampi / timestamplu (util.h:56-58)."""
    timestamp("%s%d" % (msg, v), stream)


def timestamp_g(msg: str, v: float, stream=None) -> None:
    """timestampd — printf %g rendering (util.h:59)."""
    timestamp("%s%g" % (msg, v), stream)


def tic() -> None:
    global _tictoc
    _tictoc = time.time()


def toc(stream=None) -> None:
    t = int(time.time() - _tictoc)
    (stream or sys.stderr).write(
        "Elapsed time: %d:%02d:%02d\n" % (t // 3600, (t % 3600) // 60, t % 60)
    )


class ProgressReporter:
    """PatternMatch::progress_interval / report_progress
    (pattern_match.h:135-155): emit ``Progress: xx.x%`` lines, throttled to
    one per ``interval`` fraction of the input stream.  The scan loops call
    ``report(frac)`` once per processed block (the reference checks after
    each candidate batch, shift_and.cc:244-248)."""

    def __init__(self, interval: float = 0.01, stream=None):
        self.pcur = 0.0
        self.pint = interval
        self.stream = stream

    def report(self, frac: float) -> None:
        if frac > self.pcur:
            timestamp("Progress:%5.1f%%" % (frac * 100), self.stream)
            self.pcur = frac + self.pint

    __call__ = report
