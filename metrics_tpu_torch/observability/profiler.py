"""``torch.profiler`` projection of the span names.

Counterpart of ``metrics_tpu/observability/jaxprof.py`` (the port names the
module after what it drives). The span tracer
(:mod:`metrics_tpu_torch.observability.trace`) measures host wall time around
enqueues and cannot see the device timeline. This module puts the same phase
names on ``torch.profiler``'s timeline, so a profile shows ``metric.update``
/ ``metric.sync`` / ``sharded.engine`` on the host track and, around the
kernels they enqueued, on the CUDA track:

- :func:`annotate` is ``torch.profiler.record_function(name)`` while tracing
  is enabled, and a shared no-op singleton (no allocation) otherwise. It
  never starts a profiler session; it labels one that is running.
- :func:`start_trace` / :func:`stop_trace` run one ``torch.profiler``
  session (CPU activity, and CUDA activity when a card is present) and
  write its Chrome trace where
  :func:`~metrics_tpu_torch.observability.devtime.from_profiler_trace` finds
  it. While the session runs, every span of the tracer opens a
  ``record_function`` scope of its own name too (``trace.PROFILER_SCOPE``),
  so the phase spans (``metric.update``, ``collection.group_update``, ...)
  show on the timeline without a site of their own. The JAX package gets the
  same from its jitted programs' names.

The span records and the session's trace are on two clocks (``perf_counter_ns``
and the profiler's microseconds). :func:`start_trace` and :func:`stop_trace`
each open an anchor: :data:`ANCHOR_SCOPES` ``record_function`` scopes named
:data:`ANCHOR` in a row, each noting the ``perf_counter_ns`` read just inside
it, as a span reads its start. The first scope of a process enters slowly
(~0.5 ms on a CPU host, between the scope's timestamp and the read), so of an
anchor's scopes the one that entered fastest is kept. :func:`stop_trace` keeps
the session (:func:`last_session`: its anchors, its span records and the
trace's device operations and host scopes) until the next
:func:`start_trace`, for
:func:`~metrics_tpu_torch.observability.devtime.idle_attribution` to read
after the trace file is gone. A scope's ``args`` string does not reach the
exported Chrome trace (torch 2.11-2.13, with or without ``record_shapes``),
so a span's record and its scope are joined by name and mapped start.
"""
import os
import socket
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

from metrics_tpu_torch.observability import trace as _trace
from metrics_tpu_torch.observability.trace import TRACE, SpanRecord

__all__ = ["ANCHOR", "ANCHOR_SCOPES", "LastSession", "annotate", "is_tracing", "last_session", "start_trace",
           "stop_trace"]

# the name of the clock-anchor scopes of a session, and how many make one anchor
ANCHOR = "observability.clock_anchor"
ANCHOR_SCOPES = 3


class _NullAnnotation:
    __slots__ = ()

    def __enter__(self) -> "_NullAnnotation":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False


_NULL = _NullAnnotation()


def annotate(name: str):
    """Label the enclosed work with ``name`` on the profiler's timeline (host
    track, and the CUDA track around the kernels it enqueues); a no-op while
    tracing is disabled."""
    if not TRACE.enabled:
        return _NULL
    import torch

    return torch.profiler.record_function(name)


class LastSession(NamedTuple):
    """What a stopped session leaves for the idle attribution."""

    anchors: Tuple[Tuple[int, ...], ...]  # perf_counter_ns reads of the start's and the stop's anchor scopes
    records: List[SpanRecord]  # the spans that started after the start's anchor and ended before the stop
    events: List[Dict[str, Any]]  # the trace's complete events of device operations and host scopes


class _Session:
    """The one running profiler session of this process, and the last one
    stopped."""

    __slots__ = ("profile", "log_dir", "anchors", "last")

    def __init__(self) -> None:
        self.profile: Any = None
        self.log_dir: Optional[str] = None
        self.anchors: Tuple[Tuple[int, ...], ...] = ()
        self.last: Optional[LastSession] = None


_SESSION = _Session()


def _anchor() -> Tuple[int, ...]:
    """:data:`ANCHOR_SCOPES` :data:`ANCHOR` scopes on the running session; the
    ``perf_counter_ns`` read inside each."""
    import torch

    reads = []
    for _ in range(ANCHOR_SCOPES):
        with torch.profiler.record_function(ANCHOR):
            reads.append(time.perf_counter_ns())
    return tuple(reads)


def last_session() -> Optional[LastSession]:
    """The last stopped session, kept until the next :func:`start_trace`;
    None before the first."""
    return _SESSION.last


def is_tracing() -> bool:
    """Whether a :func:`start_trace` session is running."""
    return _SESSION.profile is not None


def start_trace(log_dir: str, host_tracer_level: Optional[int] = None) -> None:
    """Start a ``torch.profiler`` session whose trace :func:`stop_trace`
    writes into ``log_dir``.

    Activities: the CPU, and CUDA when ``torch.cuda.is_available()``.
    ``host_tracer_level`` keeps the JAX package's signature: at 2 or more the
    session also records operator shapes, at 3 or more Python stacks.
    """
    if _SESSION.profile is not None:
        raise RuntimeError("a profiler session is running already; call stop_trace() first")
    import torch

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    level = 1 if host_tracer_level is None else int(host_tracer_level)
    profile = torch.profiler.profile(activities=activities, record_shapes=level >= 2, with_stack=level >= 3)
    _SESSION.last = None
    profile.start()
    _SESSION.profile, _SESSION.log_dir = profile, str(log_dir)
    _SESSION.anchors = (_anchor(),)
    _trace.PROFILER_SCOPE = torch.profiler.record_function


def stop_trace() -> str:
    """Stop the session and write ``<log_dir>/<host>.<pid>.trace.json``;
    returns that path. The session is kept as :func:`last_session` (its
    device operations and host scopes read back from that file)."""
    from metrics_tpu_torch.observability.devtime import timeline_events

    profile, log_dir = _SESSION.profile, _SESSION.log_dir
    if profile is None:
        raise RuntimeError("no profiler session is running; call start_trace() first")
    _trace.PROFILER_SCOPE = None
    anchors = _SESSION.anchors + (_anchor(),)
    began = min(anchors[0])
    records = [r for r in _trace.records() if r.start_ns >= began]
    _SESSION.profile = _SESSION.log_dir = None
    profile.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{socket.gethostname()}.{os.getpid()}.trace.json")
    profile.export_chrome_trace(path)
    _SESSION.last = LastSession(anchors, records, timeline_events(path))
    return path
