"""Device milliseconds of NCCL kernels a unit (kernel names holding
``nccl``), the mean over the profiled units."""
from portbench.trace_reader import unit_mean_ms

UNIT = "ms"


def read(rec):
    return unit_mean_ms(rec["trace"], lambda name: "nccl" in name)
