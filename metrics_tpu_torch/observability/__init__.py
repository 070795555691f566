"""Observability of the port: spans, collective accounting, device time,
compile telemetry, the health planes and export.

Counterpart of ``metrics_tpu/observability/``, with every name of its
``__all__``. All of it is off by default, and the disabled path allocates
nothing:

- :mod:`~metrics_tpu_torch.observability.trace`: the monotonic-clock span
  tracer (context manager and decorator, thread-local nesting) over the hot
  paths: ``Metric.forward`` / ``update`` / ``sync_state`` / ``compute``, the
  collection's group update, step sync, host sync and compute, the deferred
  plane, the sharded launches; and the port's own around a collection step
  (``collection.forward``, ``collection.lockstep``,
  ``metric.forward_update``), each span with its id, its parent's and its
  root's.
- :mod:`~metrics_tpu_torch.observability.counters`: collective calls and
  bytes, states synced, faults, the deferred and sparse ledgers, the
  wrappers' gauges, ``state_bytes``, the health gauges and the cache pairs,
  in the JAX package's snapshot schema.
- :mod:`~metrics_tpu_torch.observability.export`: ``summarize()``, the
  JSON-lines dump and the Chrome trace (Perfetto).
- :mod:`~metrics_tpu_torch.observability.profiler` (the JAX package's
  ``jaxprof``): ``annotate`` / ``start_trace`` / ``stop_trace`` over
  ``torch.profiler``.
- :mod:`~metrics_tpu_torch.observability.compilemon`: the kernel builds and
  loads of ``ops/build.py`` as compile events, cache hits and misses, and
  ``compiled=yes/no`` on the spans they land in.
- :mod:`~metrics_tpu_torch.observability.devtime`: per-phase fencing on the
  CUDA streams a phase's outputs live on (``device_ms``),
  ``device_time_table()``, ``from_profiler_trace()``, and
  ``idle_attribution()``: a profiled window's device-idle time by the span
  and layer the host was in, on the profiler's clock.
- :mod:`~metrics_tpu_torch.observability.lifecycle`: the window-lifecycle
  ledger (``first_event`` ... ``banked``) and flow ids.
- :mod:`~metrics_tpu_torch.observability.selfmeter`: ``LatencyMeter``
  sketches of stage latencies, bit-equal to the JAX package's.
- :mod:`~metrics_tpu_torch.observability.regress`: the trajectory gate
  (``load_rounds``, ``check_trajectory``).

Typical use::

    from metrics_tpu_torch import observability as obs

    obs.enable()                          # or enable(device_time=True)
    ...  # run the eval loop
    print(obs.summarize())                # per-phase ms, keyed by span name
    print(obs.device_time_table())        # per-metric device ms (fenced)
    print(obs.counters_snapshot())        # collective calls / bytes / gauges
    obs.write_chrome_trace("trace.json")  # load in ui.perfetto.dev
    obs.disable()
"""
from typing import Any, Dict

from metrics_tpu_torch.observability import compilemon as _compilemon_mod
from metrics_tpu_torch.observability import counters  # noqa: F401
from metrics_tpu_torch.observability import counters as _counters_mod
from metrics_tpu_torch.observability import devtime as _devtime_mod
from metrics_tpu_torch.observability import lifecycle as _lifecycle_mod
from metrics_tpu_torch.observability import trace as _trace_mod
from metrics_tpu_torch.observability.counters import COUNTERS, CollectiveCounters
from metrics_tpu_torch.observability.devtime import device_time_table
from metrics_tpu_torch.observability.export import (
    chrome_trace,
    summarize,
    to_trace_events,
    write_chrome_trace,
    write_jsonl,
)
from metrics_tpu_torch.observability.lifecycle import LEDGER, STAGES, next_flow_id
from metrics_tpu_torch.observability.profiler import annotate, start_trace, stop_trace
from metrics_tpu_torch.observability.regress import check_trajectory, load_rounds
from metrics_tpu_torch.observability.selfmeter import SELFMETER, LatencyMeter, merge_meters
from metrics_tpu_torch.observability.trace import TRACE, SpanRecord, records, span, traced

__all__ = [
    "COUNTERS",
    "CollectiveCounters",
    "LEDGER",
    "LatencyMeter",
    "SELFMETER",
    "STAGES",
    "SpanRecord",
    "TRACE",
    "annotate",
    "check_trajectory",
    "chrome_trace",
    "compile_snapshot",
    "counters_snapshot",
    "device_time_table",
    "disable",
    "enable",
    "is_enabled",
    "load_rounds",
    "merge_meters",
    "next_flow_id",
    "records",
    "reset",
    "span",
    "start_trace",
    "stop_trace",
    "summarize",
    "to_trace_events",
    "traced",
    "write_chrome_trace",
    "write_jsonl",
]


def enable(
    spans: bool = True,
    counters: bool = True,
    compile_events: bool = False,
    device_time: bool = False,
) -> None:
    """Turn observability on.

    ``spans`` / ``counters`` are the passive layers (they record and never
    perturb). ``compile_events`` counts the kernel builds and loads and stamps
    every span ``compiled=yes/no`` (:mod:`~metrics_tpu_torch.observability.
    compilemon`). ``device_time`` fences every phase so spans carry
    ``device_ms`` (:mod:`~metrics_tpu_torch.observability.devtime`): a
    measurement mode that serializes host and device; keep it off when timing
    end-to-end throughput.
    """
    if spans:
        _trace_mod.enable()
    if counters:
        # the lifecycle ledger rides the counters gate: its whole output
        # (lifecycle / watermark_lag / publish_staleness / selfmeter) is
        # counters gauge blocks
        _counters_mod.enable()
        _lifecycle_mod.enable()
    if compile_events:
        _compilemon_mod.enable()
    if device_time:
        _devtime_mod.enable()


def disable() -> None:
    _trace_mod.disable()
    _counters_mod.disable()
    _lifecycle_mod.disable()
    _compilemon_mod.disable()
    _devtime_mod.disable()


def is_enabled() -> bool:
    return _trace_mod.is_enabled() or _counters_mod.is_enabled()


def reset() -> None:
    """Drop every recorded span, zero every counter and the compile totals,
    and clear the lifecycle ledger and the self-meter sketches."""
    _trace_mod.clear()
    _counters_mod.reset()
    _lifecycle_mod.clear()
    _compilemon_mod.reset()


def counters_snapshot(reset_after: bool = False) -> Dict[str, Any]:
    return _counters_mod.snapshot(reset_after=reset_after)


def compile_snapshot() -> Dict[str, Any]:
    """Compile telemetry of the kernel builds: event count, per-phase ms,
    cache hits and misses (see :mod:`~metrics_tpu_torch.observability.compilemon`)."""
    return _compilemon_mod.snapshot()
