"""Observability of the port: the counters registry (``counters.py``) of the
keyed wrappers and the watermark agreement. The JAX package's tracing, export
and lifecycle planes and its package-level ``enable`` / ``disable`` /
``reset`` / ``counters_snapshot`` are not ported yet."""
from metrics_tpu_torch.observability import counters  # noqa: F401
from metrics_tpu_torch.observability.counters import COUNTERS, CollectiveCounters  # noqa: F401

__all__ = ["COUNTERS", "CollectiveCounters", "counters"]
