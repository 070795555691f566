"""Per-phase device-time attribution for the metric hot paths.

Counterpart of ``metrics_tpu/observability/devtime.py``. The span tracer
measures host wall time around enqueues; CUDA keeps running after a span
closes, so a span alone understates a phase's cost and smears its kernels
into whichever span is open when someone finally waits. This module charges
device work to the phase names two ways:

1. **Fence mode** (:func:`enable`, and the :func:`fence` calls the
   instrumented sites carry): at the end of each phase (``metric.update``,
   ``metric.sync_state``, ``metric.compute``, ``collection.*``,
   ``sharded.launch``) the site hands its outputs to :func:`fence`, which
   synchronizes the current stream of every CUDA device those tensors live
   on and charges the wait to the enclosing span as ``device_ms``. Every
   phase fences, so the queue is empty at each phase boundary and
   ``device_ms`` is the device tail the host waited out after the enqueue
   returned. Fencing serializes host and device: a measurement mode, off by
   default, one falsy attribute check while disabled. A value held on the
   CPU alone synchronizes nothing and never initializes CUDA; its
   ``device_ms`` is the (near-zero) walk over its tensors.

2. **Profiler mode** (:func:`from_profiler_trace`): when a ``torch.profiler``
   session wrote a Chrome trace (:func:`~metrics_tpu_torch.observability.
   profiler.stop_trace`), the phase names that
   :func:`~metrics_tpu_torch.observability.profiler.annotate` and the
   spans' ``record_function`` scopes put on the timeline are read back and
   summed per phase: the kernels' own time, without fencing.

:func:`device_time_table` folds the fenced spans into a per-metric,
per-phase table, as the JAX package's does.
"""
import gzip
import json
import os
import time
from typing import Any, Dict, Iterator, List, Optional

import torch

from metrics_tpu_torch.observability import trace as _trace
from metrics_tpu_torch.observability.trace import SpanRecord, current_span

__all__ = [
    "DEVTIME",
    "PHASE_OF_SPAN",
    "device_time_table",
    "disable",
    "enable",
    "fence",
    "from_profiler_trace",
    "is_enabled",
]

# span name -> phase column of the device-time table: the JAX package's
# vocabulary. The port has no fused collection step, so "collection.fused_step"
# never appears in its traces; it stays so that both tables read the same names.
PHASE_OF_SPAN: Dict[str, str] = {
    "metric.update": "update",
    "metric.sync_state": "sync",
    "metric.compute": "compute",
    "metric.forward": "forward",
    "collection.group_update": "update",
    "collection.fused_step": "update",
    "collection.forward_batched": "update",
    "collection.host_sync": "sync",
    "collection.step_sync": "sync",
    "collection.compute": "compute",
    "sharded.launch": "engine",
}

# the profiler's event categories of a record_function scope: one host event
# and, when the scope enqueued CUDA work, one device event over its kernels
_HOST_ANNOTATION = "user_annotation"
_DEVICE_ANNOTATION = "gpu_user_annotation"


class _DevTimeState:
    """Process-wide fencing switch; ``enabled`` is the hot-path gate."""

    __slots__ = ("enabled",)

    def __init__(self) -> None:
        self.enabled = False


DEVTIME = _DevTimeState()


def enable() -> None:
    """Turn on per-phase fencing (spans gain ``device_ms``; the pipeline serializes)."""
    DEVTIME.enabled = True


def disable() -> None:
    DEVTIME.enabled = False


def is_enabled() -> bool:
    return DEVTIME.enabled


def _tensors(value: Any) -> Iterator[torch.Tensor]:
    """Every tensor in a phase's output: tensors, and dicts, lists and tuples
    (buffers and sketches are NamedTuples) of them."""
    if isinstance(value, torch.Tensor):
        yield value
    elif isinstance(value, dict):
        for v in value.values():
            yield from _tensors(v)
    elif isinstance(value, (list, tuple)):
        for v in value:
            yield from _tensors(v)


def fence(value: Any) -> None:
    """Wait until ``value``'s CUDA work is done; charge the wait to the
    innermost open span as ``device_ms``.

    Call at the END of a phase, inside its span, with the phase's outputs.
    The wait synchronizes the current stream of each CUDA device the value's
    tensors live on (not every device: ``torch.cuda.synchronize()`` would
    also wait for work the phase did not enqueue on other cards). No-op while
    disabled.
    """
    if not DEVTIME.enabled:
        return
    start_ns = time.perf_counter_ns()
    devices = {t.device for t in _tensors(value) if t.is_cuda}
    for device in devices:
        torch.cuda.current_stream(device).synchronize()
    waited_ms = (time.perf_counter_ns() - start_ns) / 1e6
    span = current_span()
    if span is not None:
        span.note("device_ms", waited_ms)


def device_time_table(records: Optional[List[SpanRecord]] = None) -> Dict[str, Dict[str, float]]:
    """Fold fenced spans into ``{metric: {phase: device_ms}}``.

    Rows come from spans carrying a ``device_ms`` attr (only fence mode stamps
    it); the row key is the span's ``metric`` attr (``group`` for the
    collection's group spans, the span name itself otherwise), the column
    :data:`PHASE_OF_SPAN`'s mapping of the span name.
    """
    if records is None:
        records = _trace.records()
    table: Dict[str, Dict[str, float]] = {}
    for rec in records:
        attrs = rec.attrs
        if not attrs:
            continue
        device_ms = attrs.get("device_ms")
        if device_ms is None:
            continue
        phase = PHASE_OF_SPAN.get(rec.name, rec.name)
        label = attrs.get("metric") or attrs.get("group")
        if label is None:
            label = "collection" if rec.name.startswith("collection.") else rec.name
        row = table.setdefault(str(label), {})
        row[phase] = row.get(phase, 0.0) + device_ms
    return table


# ------------------------------------------------- profiler-session parsing
def _iter_trace_files(log_dir: str) -> Iterator[str]:
    """Chrome JSON trace files under a profiler log dir."""
    for root, _dirs, files in os.walk(log_dir):
        for name in files:
            if name.endswith((".trace.json", ".trace.json.gz")) or name in (
                "perfetto_trace.json.gz",
                "perfetto_trace.json",
            ):
                yield os.path.join(root, name)


def _load_trace_events(path: str) -> List[Dict[str, Any]]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        doc = json.load(f)
    if isinstance(doc, dict):
        return doc.get("traceEvents", [])
    return doc if isinstance(doc, list) else []


def from_profiler_trace(log_dir: str) -> Dict[str, float]:
    """Sum the time of each projected phase from a profiler session's traces.

    Scans ``log_dir`` for Chrome JSON traces (``torch.profiler``'s
    ``export_chrome_trace``, as :func:`~metrics_tpu_torch.observability.
    profiler.stop_trace` writes them) and totals the duration of complete
    (``"ph": "X"``) events whose name contains one of the
    :data:`PHASE_OF_SPAN` names or the ``metric.sync`` / ``sharded.engine``
    scopes, the longest name first, as the JAX package matches them.

    ``torch.profiler`` writes each ``record_function`` scope twice: a host
    event (category ``user_annotation``, the host time inside the scope) and,
    when the scope enqueued CUDA work, a device event (``gpu_user_annotation``,
    from its first kernel's start to its last kernel's end). Adding both would
    count a phase twice, so for each phase the device events are taken when
    the trace has any for it, and the host events otherwise (a phase with no
    CUDA work, or a CPU-only session). Returns ``{phase name: ms}``; an
    absent or empty directory gives ``{}``.
    """
    known = sorted({*PHASE_OF_SPAN, "metric.sync", "sharded.engine"}, key=len, reverse=True)
    host: Dict[str, float] = {}
    device: Dict[str, float] = {}
    if not os.path.isdir(log_dir):
        return {}
    for path in _iter_trace_files(log_dir):
        try:
            events = _load_trace_events(path)
        except (OSError, ValueError):
            continue
        for event in events:
            if event.get("ph") != "X":
                continue
            name = event.get("name")
            dur_us = event.get("dur")
            if not isinstance(name, str) or not isinstance(dur_us, (int, float)):
                continue
            totals = device if event.get("cat") == _DEVICE_ANNOTATION else host
            for phase in known:
                if phase in name:
                    totals[phase] = totals.get(phase, 0.0) + dur_us / 1e3
                    break
    return {phase: device.get(phase, host.get(phase, 0.0)) for phase in sorted({*host, *device})}
