"""model_idle_ms: device-idle ms a query in the self time of the model
layer's spans (``model.*`` of the port's ``utils/trace``: engine choice,
host tables, gate build, extension, dedup, emission order, the final
alignment and ``Hit`` per hit), the mean over the traced queries and
over the cell's cards."""

from ._program import idle_ms_per_query


def read(trace):
    return idle_ms_per_query(trace, "model")
