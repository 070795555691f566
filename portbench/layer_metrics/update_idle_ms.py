"""Milliseconds a unit in which rank 0's card ran nothing while the host's
innermost span was in the batch updates (``metric.forward_update``,
``metric.update``, ``collection.group_update``), by ``devtime.LAYER_OF_SPAN``: the port's own
attribution of the profiled traced units' window, the mean over the units
(``portbench/span_layers.py``)."""
from portbench import span_layers

UNIT = "ms"


def read(rec):
    return span_layers.per_unit(rec, "idle_ms", "update")
