"""Lightweight span tracer for the metric hot paths.

Counterpart of ``metrics_tpu/observability/trace.py``, with the same design
constraints, in order:

1. **Off by default, with a strictly zero-allocation disabled path.** The
   instrumented call sites are the per-step hot paths (``Metric.forward``,
   the collection's group update and step sync, the sync planes); when
   tracing is off they pay one attribute load and a falsy branch: no dict,
   no tuple, no context manager instance. ``span()`` therefore takes
   ``attrs`` as an optional positional (never ``**kwargs``, which allocates a
   dict per call) and returns a process-wide ``_NullSpan`` singleton while
   disabled.
2. **Monotonic clocks.** Spans are measured with ``time.perf_counter_ns()``;
   the wall-clock epoch anchor for export is taken once, at ``enable()``.
3. **Thread-correct nesting.** The open-span stack is thread-local, so spans
   from concurrent threads (the deferred host plane's worker among them) nest
   within their own thread; finished spans land in per-thread buffers that
   ``records()`` merges, keeping the enabled path lock-free (the only lock
   guards buffer registration, once per thread).

A span records host wall time. Around CUDA work it measures the enqueue, not
the kernels: :mod:`metrics_tpu_torch.observability.devtime` fences a phase and
stamps its span with ``device_ms``, and
:mod:`metrics_tpu_torch.observability.profiler` projects the same phase names
into ``torch.profiler`` traces. With
:mod:`metrics_tpu_torch.observability.compilemon` enabled, every finished span
also carries ``compiled=yes/no`` (did a kernel build or load land inside it)
and, when the build took time, ``compile_ms``.
"""
import functools
import itertools
import threading
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional

__all__ = [
    "SpanRecord",
    "TRACE",
    "current_span",
    "enable",
    "disable",
    "is_enabled",
    "clear",
    "records",
    "span",
    "traced",
]


class SpanRecord(NamedTuple):
    """One finished span (times in ns on the ``perf_counter_ns`` clock).

    The first seven fields are the JAX package's. ``span_id`` is unique in the
    process; ``parent_id`` is the enclosing span's id, and ``root_id`` the id
    of the outermost span open on the thread at entry (its own at top level),
    so every span of one collection step carries the id of its
    ``collection.forward``. Records built by hand default them to 0 / None."""

    name: str
    start_ns: int
    end_ns: int
    thread_id: int
    depth: int  # nesting depth within the thread at entry (0 = top level)
    parent: Optional[str]  # innermost enclosing span name, if any
    attrs: Optional[Dict[str, Any]]
    span_id: int = 0
    parent_id: Optional[int] = None
    root_id: int = 0

    @property
    def duration_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6


class _TraceState:
    """Process-wide tracer state; ``TRACE.enabled`` is the hot-path gate."""

    __slots__ = ("enabled", "epoch_anchor", "_buffers", "_lock", "_tls")

    def __init__(self) -> None:
        self.enabled = False
        # (time.time_ns, perf_counter_ns) pair captured at enable(): exports
        # can map the monotonic span times onto the wall clock
        self.epoch_anchor = (time.time_ns(), time.perf_counter_ns())
        self._buffers: List[List[SpanRecord]] = []
        self._lock = threading.Lock()
        self._tls = threading.local()

    # ------------------------------------------------------------- buffers
    def _thread_buffer(self) -> List[SpanRecord]:
        buf = getattr(self._tls, "buffer", None)
        if buf is None:
            buf = []
            self._tls.buffer = buf
            with self._lock:
                self._buffers.append(buf)
        return buf

    def _thread_stack(self) -> list:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = []
            self._tls.stack = stack
        return stack

    def records(self) -> List[SpanRecord]:
        """All finished spans, merged across threads, in start order."""
        with self._lock:
            merged = [rec for buf in self._buffers for rec in buf]
        merged.sort(key=lambda r: r.start_ns)
        return merged

    def clear(self) -> None:
        with self._lock:
            for buf in self._buffers:
                del buf[:]


TRACE = _TraceState()


class _NullSpan:
    """The disabled-path span: a singleton, allocation-free no-op."""

    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False


_NULL_SPAN = _NullSpan()

# Set by observability.compilemon while compile monitoring is on: a zero-arg
# callable returning this thread's cumulative (kernel build-or-load count,
# build ns). Spans snapshot it on entry and diff on exit to stamp
# ``compiled=yes/no`` + ``compile_ms``. None keeps spans exactly as before
# (attrs untouched), so plain tracing pays nothing for the feature.
COMPILE_PROBE: Optional[Callable[[], tuple]] = None

# Set by observability.profiler while a torch.profiler session runs: a
# callable taking a span name and returning a context manager
# (``torch.profiler.record_function``). Every span then also opens that scope,
# so the session's timeline carries the span names (on the CUDA track too,
# around the kernels the span enqueued). None outside a session.
PROFILER_SCOPE: Optional[Callable[[str], Any]] = None

# span ids, unique in the process (``next`` on a count is atomic under the GIL)
_IDS = itertools.count(1)


class _Span:
    """An open span; created only while tracing is enabled."""

    __slots__ = ("name", "attrs", "_start_ns", "_depth", "_parent", "_compile0", "_scope", "_id", "_parent_id",
                 "_root_id")

    def __init__(self, name: str, attrs: Optional[Dict[str, Any]]) -> None:
        self.name = name
        self.attrs = attrs

    def note(self, key: str, ms: float) -> None:
        """Accumulate a float attr on this (still-open) span.

        The device-time fence (:mod:`~metrics_tpu_torch.observability.devtime`)
        uses this to charge post-dispatch device waits to the innermost
        enclosing phase span.
        """
        attrs = self.attrs
        if attrs is None:
            attrs = self.attrs = {}
        attrs[key] = attrs.get(key, 0.0) + ms

    def __enter__(self) -> "_Span":
        stack = TRACE._thread_stack()
        self._depth = len(stack)
        self._id = next(_IDS)
        if stack:
            self._parent, self._parent_id, self._root_id = stack[-1].name, stack[-1]._id, stack[0]._id
        else:
            self._parent, self._parent_id, self._root_id = None, None, self._id
        stack.append(self)
        probe = COMPILE_PROBE
        self._compile0 = probe() if probe is not None else None
        scope = PROFILER_SCOPE
        self._scope = scope(self.name) if scope is not None else None
        if self._scope is not None:
            self._scope.__enter__()
        self._start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc: Any) -> bool:
        end_ns = time.perf_counter_ns()
        if self._scope is not None:
            self._scope.__exit__(*exc)
        stack = TRACE._thread_stack()
        if stack and stack[-1] is self:
            stack.pop()
        if self._compile0 is not None:
            probe = COMPILE_PROBE
            if probe is not None:
                count0, ns0 = self._compile0
                count1, ns1 = probe()
                attrs = self.attrs
                if attrs is None:
                    attrs = self.attrs = {}
                # "compiled" means a kernel library was built or loaded inside
                # this span (an nvcc run, or a build found in the cache);
                # compile_ms is the build time of the window
                attrs.setdefault("compiled", "yes" if count1 > count0 else "no")
                if ns1 > ns0:
                    attrs["compile_ms"] = attrs.get("compile_ms", 0.0) + (ns1 - ns0) / 1e6
        TRACE._thread_buffer().append(
            SpanRecord(
                self.name,
                self._start_ns,
                end_ns,
                threading.get_ident(),
                self._depth,
                self._parent,
                self.attrs,
                self._id,
                self._parent_id,
                self._root_id,
            )
        )
        return False


def current_span() -> Optional[_Span]:
    """The innermost OPEN span on this thread, or None (devtime stamps it)."""
    stack = getattr(TRACE._tls, "stack", None)
    return stack[-1] if stack else None


def span(name: str, attrs: Optional[Dict[str, Any]] = None):
    """Context manager timing ``name``; a no-op singleton while disabled.

    ``attrs`` is an optional dict of static labels (metric class, leaf count).
    Hot call sites should build it only behind a ``TRACE.enabled`` check so
    the disabled path allocates nothing.
    """
    if not TRACE.enabled:
        return _NULL_SPAN
    return _Span(name, attrs)


def traced(name: Optional[str] = None) -> Callable:
    """Decorator form of :func:`span`; span name defaults to the qualname."""

    def decorate(fn: Callable) -> Callable:
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*args: Any, **kwargs: Any) -> Any:
            if not TRACE.enabled:
                return fn(*args, **kwargs)
            with _Span(label, None):
                return fn(*args, **kwargs)

        return wrapper

    return decorate


def enable() -> None:
    """Turn span recording on (records into process memory until cleared)."""
    TRACE.epoch_anchor = (time.time_ns(), time.perf_counter_ns())
    TRACE.enabled = True


def disable() -> None:
    TRACE.enabled = False


def is_enabled() -> bool:
    return TRACE.enabled


def clear() -> None:
    """Drop all recorded spans (open spans are unaffected)."""
    TRACE.clear()


def records() -> List[SpanRecord]:
    return TRACE.records()
