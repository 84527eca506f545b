"""scanner_idle_ms: device-idle ms a query in the self time of the scanner
layer's spans (``scan.*`` of the port's ``utils/trace``: device and filter
tables, uploads, dispatch, the wait for a row, decode, re-launches), the
mean over the traced queries and over the cell's cards."""

from ._program import idle_ms_per_query


def read(trace):
    return idle_ms_per_query(trace, "scan")
