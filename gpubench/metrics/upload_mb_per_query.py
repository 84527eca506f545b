"""upload_mb_per_query: bytes of text and tables the port puts on the
device per completed query (the ``upload.bytes`` count inside the
window), in MB."""

from ._program import counted


def read(trace):
    n = counted(trace, lambda name: name == "upload.bytes")
    if n is None or not trace.queries:
        return None
    return n / len(trace.queries) / 1e6
