"""verify_yield_pct: the share of the filter engine's clusters handed to
the batched verify that it keeps (``cand.verify_ok`` over
``cand.verify_in`` inside the window), in percent; None where no
cluster reached the verify (another engine, or a program without the
counters)."""

from ._program import counted


def read(trace):
    tried = counted(trace, lambda name: name == "cand.verify_in")
    ok = counted(trace, lambda name: name == "cand.verify_ok")
    if not tried:
        return None
    return 100.0 * ok / tried
