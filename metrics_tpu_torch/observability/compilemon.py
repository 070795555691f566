"""Compile telemetry of the port's kernel builds.

Counterpart of ``metrics_tpu/observability/compilemon.py``. The JAX package
listens to ``jax.monitoring``'s compile events; the one thing the port
compiles is its CUDA kernels (``ops/build.py``), so this module maps the
same snapshot and span stamps onto the kernel loader:

- a library built by ``nvcc`` is a compile event and a cache **miss**; its
  build and load seconds go into ``backend_compile_ms``;
- a library found already built in the build directory is a compile event
  and a cache **hit**, its load seconds into ``backend_compile_ms``: the JAX
  package's persistent-cache retrieval, where ``backend_compile_duration``
  fires too (an executable was still made ready for this process);
- ``trace_ms`` and ``lowering_ms`` stay in the snapshot at 0: the port
  traces and lowers nothing.

A library is loaded once a process (``KernelLibraries.load`` keeps it), so
only the first call of a kernel in a process lands an event.

While enabled, ``trace.COMPILE_PROBE`` points at this module's per-thread
accumulator: every finished span diffs it and carries ``compiled=yes`` when a
build or load landed inside it on its thread, ``compiled=no`` otherwise, and
``compile_ms`` when that took time. The loader reports each load through
``ops.build.LOAD_HOOK``, which :func:`enable` points at ``MONITOR`` and
:func:`disable` clears; while disabled a load costs one ``None`` check.
"""
import threading
from typing import Any, Dict, Tuple

from metrics_tpu_torch.observability import trace as _trace

__all__ = ["MONITOR", "enable", "disable", "is_enabled", "reset", "snapshot"]

# snapshot columns, the JAX package's names
_DURATION_COLUMNS = ("trace_ms", "lowering_ms", "backend_compile_ms")


class _CompileMonitor:
    """Process-wide build accounting; ``enabled`` is the gate."""

    __slots__ = ("enabled", "compile_events", "ms_totals", "cache_hits", "cache_misses", "_lock", "_tls")

    def __init__(self) -> None:
        self.enabled = False
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._zero()

    def _zero(self) -> None:
        self.compile_events = 0
        self.ms_totals: Dict[str, float] = {c: 0.0 for c in _DURATION_COLUMNS}
        self.cache_hits = 0
        self.cache_misses = 0

    def on_kernel_load(self, name: str, hit: bool, seconds: float) -> None:
        """One kernel library made ready for this process: found built
        (``hit``) or built by ``nvcc``, in ``seconds``."""
        if not self.enabled:
            return
        with self._lock:
            self.compile_events += 1
            self.ms_totals["backend_compile_ms"] += seconds * 1e3
            if hit:
                self.cache_hits += 1
            else:
                self.cache_misses += 1
        # the build runs on the calling thread: the probe charges it to the
        # span open there
        tls = self._tls
        tls.compile_ns = getattr(tls, "compile_ns", 0) + int(seconds * 1e9)
        tls.compile_count = getattr(tls, "compile_count", 0) + 1

    def _probe(self) -> Tuple[int, int]:
        tls = self._tls
        return getattr(tls, "compile_count", 0), getattr(tls, "compile_ns", 0)

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "compile_events": self.compile_events,
                "backend_compile_ms": round(self.ms_totals["backend_compile_ms"], 3),
                "trace_ms": round(self.ms_totals["trace_ms"], 3),
                "lowering_ms": round(self.ms_totals["lowering_ms"], 3),
                "compile_cache": {"hits": self.cache_hits, "misses": self.cache_misses},
            }

    def reset(self) -> None:
        with self._lock:
            self._zero()


MONITOR = _CompileMonitor()


def enable() -> None:
    """Start counting kernel builds and loads and stamping spans with ``compiled=``."""
    from metrics_tpu_torch.ops import build

    MONITOR.enabled = True
    build.LOAD_HOOK = MONITOR.on_kernel_load
    _trace.COMPILE_PROBE = MONITOR._probe


def disable() -> None:
    from metrics_tpu_torch.ops import build

    MONITOR.enabled = False
    build.LOAD_HOOK = None
    _trace.COMPILE_PROBE = None


def is_enabled() -> bool:
    return MONITOR.enabled


def reset() -> None:
    """Zero the process totals (the per-thread span probes keep their
    cumulative counts: spans diff them, so absolute values never matter)."""
    MONITOR.reset()


def snapshot() -> Dict[str, Any]:
    """JSON-ready compile telemetry: event count, per-phase ms, cache pair."""
    return MONITOR.snapshot()
