"""extend_yield_pct: the share of the seed candidates handed to the host
extension that extend to a hit before the dedup (``cand.extend_ok`` over
``cand.extend_in`` inside the window), in percent; None where no
candidate reached the extension (an exact engine)."""

from ._program import counted


def read(trace):
    tried = counted(trace, lambda name: name == "cand.extend_in")
    ok = counted(trace, lambda name: name == "cand.extend_ok")
    if not tried:
        return None
    return 100.0 * ok / tried
