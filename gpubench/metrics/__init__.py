"""Readers of the per-layer metrics, one module per metric, named as the
metric is in ``BENCHMARK.json``.  Each has ``read(trace)``, taking a
:class:`gpubench.trace.Trace`, and returns the metric's value, or None
where the traced window holds nothing for it to read."""
