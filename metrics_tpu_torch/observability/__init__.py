"""Observability of the port: so far the counters of the keyed wrappers
(``counters.py``). The JAX package's tracing, export and lifecycle planes are
not ported yet."""
from metrics_tpu_torch.observability import counters  # noqa: F401
