"""launches_per_query: kernel launches on the devices per completed query
(copies and sets not counted), from the profiler's trace: the sum over
the cell's cards."""


def read(trace):
    kernels = sum(1 for op in trace.ops if op.is_kernel)
    if not trace.queries or not kernels:
        return None
    return kernels / len(trace.queries)
