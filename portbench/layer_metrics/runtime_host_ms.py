"""Host self milliseconds a unit in the collection and metric runtime (the self time of
``collection.forward``, ``collection.lockstep``, ``metric.forward`` and
``metric.compute``), by ``devtime.LAYER_OF_SPAN``:
each span's duration less what its child spans cover, from the port's span
records of the profiled traced units, the mean over the units
(``portbench/span_layers.py``)."""
from portbench import span_layers

UNIT = "ms"


def read(rec):
    return span_layers.per_unit(rec, "host_self_ms", "runtime")
