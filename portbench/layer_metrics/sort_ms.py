"""Device milliseconds of sort kernels a unit (kernel names holding
``sort``, as ``chip_smoke.py``'s epoch profile matches them), the mean over
the profiled units."""
from portbench.trace_reader import unit_mean_ms

UNIT = "ms"


def read(rec):
    return unit_mean_ms(rec["trace"], lambda name: "sort" in name)
