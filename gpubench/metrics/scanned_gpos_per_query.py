"""scanned_gpos_per_query: text positions the port's text-scanning kernels
cover per completed query (the ``scan.positions`` count inside the
window: a pass over the database per launch, and again per re-launch),
in billions."""

from ._program import counted


def read(trace):
    n = counted(trace, lambda name: name == "scan.positions")
    if n is None or not trace.queries:
        return None
    return n / len(trace.queries) / 1e9
