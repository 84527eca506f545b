"""glue_launches_per_query: kernels in the device trace per completed
query that are not the port's own (the ``launch.*`` counts of its six
CUDA wrappers inside the window): torch's gathers, scans, products and
fills around them; the sum over the cell's cards."""

from ._program import counted


def read(trace):
    own = counted(trace, lambda name: name.startswith("launch."))
    kernels = sum(1 for op in trace.ops if op.is_kernel)
    if own is None or not trace.queries or not kernels:
        return None
    return (kernels - own) / len(trace.queries)
