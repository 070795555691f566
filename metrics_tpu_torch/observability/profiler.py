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
"""
import os
import socket
from typing import Any, Optional

from metrics_tpu_torch.observability import trace as _trace
from metrics_tpu_torch.observability.trace import TRACE

__all__ = ["annotate", "is_tracing", "start_trace", "stop_trace"]


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


class _Session:
    """The one running profiler session of this process."""

    __slots__ = ("profile", "log_dir")

    def __init__(self) -> None:
        self.profile: Any = None
        self.log_dir: Optional[str] = None


_SESSION = _Session()


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
    profile.start()
    _SESSION.profile, _SESSION.log_dir = profile, str(log_dir)
    _trace.PROFILER_SCOPE = torch.profiler.record_function


def stop_trace() -> str:
    """Stop the session and write ``<log_dir>/<host>.<pid>.trace.json``;
    returns that path."""
    profile, log_dir = _SESSION.profile, _SESSION.log_dir
    if profile is None:
        raise RuntimeError("no profiler session is running; call start_trace() first")
    _SESSION.profile = _SESSION.log_dir = None
    _trace.PROFILER_SCOPE = None
    profile.stop()
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"{socket.gethostname()}.{os.getpid()}.trace.json")
    profile.export_chrome_trace(path)
    return path
