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

3. **Idle attribution** (:func:`idle_attribution`, the port's own): the span
   records are mapped onto a profiler trace's clock through the session's two
   clock anchors (:func:`~metrics_tpu_torch.observability.profiler.
   clock_anchors`), and every interval of a window in which no kernel, copy or
   memset ran is put down to the innermost span the host was in, and to its
   layer (:data:`LAYER_OF_SPAN`: ``runtime``, ``update``, ``sync``), or to
   ``outside`` where it was in none. :func:`span_self_ms` gives each layer's
   host self time (a span's duration less what its child spans cover) from
   the records alone.

:func:`device_time_table` folds the fenced spans into a per-metric,
per-phase table, as the JAX package's does.
"""
import bisect
import gzip
import json
import os
import time
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import torch

from metrics_tpu_torch.observability import trace as _trace
from metrics_tpu_torch.observability.trace import SpanRecord, current_span

__all__ = [
    "DEVTIME",
    "PHASE_OF_SPAN",
    "device_time_table",
    "disable",
    "enable",
    "JOIN_TOLERANCE_US",
    "LAYER_OF_SPAN",
    "fence",
    "from_profiler_trace",
    "idle_attribution",
    "is_enabled",
    "span_self_ms",
    "timeline_events",
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

# the port's spans that the JAX package does not record (its fused forward has
# no update span, and its collection step no root or lockstep span)
_PORT_ONLY_SPANS = ("collection.forward", "collection.lockstep", "metric.forward_update")

# The CUDA track gives each kernel to its innermost scope alone, so a fused
# forward's update kernels, scoped ``metric.forward_update``, leave
# ``metric.forward``'s device event (23.8 -> 0.02 ms on an SSIM + PSNR forward
# of 16 x 3 x 512 x 512, the rest 23.7 ms under the update's scope, H100). On
# the device track they count to the phase the JAX package names; on the host
# track scopes nest, and the update's time is inside metric.forward's already.
_DEVICE_PHASE_OF_PORT_SPAN = {"metric.forward_update": "metric.forward"}

# span name -> layer of a collection step, for the idle attribution and the
# host self time: PHASE_OF_SPAN's names and the port's own. ``runtime`` is the
# collection's and the metric's bookkeeping (the self time of the spans that
# only hold others), ``update`` a batch update, ``sync`` a cross-rank sync.
# Any other span is ``other``; time in no span is ``outside``.
LAYER_OF_SPAN: Dict[str, str] = {
    "metric.forward_update": "update",
    "metric.update": "update",
    "collection.group_update": "update",
    "collection.fused_step": "update",
    "metric.sync_state": "sync",
    "collection.step_sync": "sync",
    "collection.host_sync": "sync",
    "collection.forward": "runtime",
    "collection.lockstep": "runtime",
    "collection.compute": "runtime",
    "collection.forward_batched": "runtime",
    "metric.forward": "runtime",
    "metric.compute": "runtime",
    "sharded.launch": "engine",
}

# the widest distance between a span's start mapped onto the trace's clock and
# the start of its record_function scope for the two to be joined
JOIN_TOLERANCE_US = 50.0

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
    absent or empty directory gives ``{}``. The port's own spans count to no
    phase of their own: a ``metric.forward_update`` device event counts to
    ``metric.forward`` (whose device event no longer holds the update's
    kernels), and every other event of theirs is passed over.
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
            on_device = event.get("cat") == _DEVICE_ANNOTATION
            if name in _PORT_ONLY_SPANS:
                name = _DEVICE_PHASE_OF_PORT_SPAN.get(name) if on_device else None
                if name is None:
                    continue
            totals = device if on_device else host
            for phase in known:
                if phase in name:
                    totals[phase] = totals.get(phase, 0.0) + dur_us / 1e3
                    break
    return {phase: device.get(phase, host.get(phase, 0.0)) for phase in sorted({*host, *device})}


# ------------------------------------------------------- idle attribution
_DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")


def _layer(name: Optional[str]) -> str:
    return "outside" if name is None else LAYER_OF_SPAN.get(name, "other")


def span_self_ms(records: Sequence[SpanRecord]) -> Dict[str, Dict[str, float]]:
    """Host self time of ``records``: each span's duration less the part its
    child spans (the records whose ``parent_id`` is its id) cover, summed
    ``by_span`` name and ``by_layer`` (:data:`LAYER_OF_SPAN`). Over the spans
    of one root the self times add up to the root's duration."""
    child_ns: Dict[int, int] = {}
    for rec in records:
        if rec.parent_id is not None:
            child_ns[rec.parent_id] = child_ns.get(rec.parent_id, 0) + rec.end_ns - rec.start_ns
    by_span: Dict[str, float] = {}
    by_layer: Dict[str, float] = {}
    for rec in records:
        ms = (rec.end_ns - rec.start_ns - child_ns.get(rec.span_id, 0)) / 1e6
        by_span[rec.name] = by_span.get(rec.name, 0.0) + ms
        layer = _layer(rec.name)
        by_layer[layer] = by_layer.get(layer, 0.0) + ms
    return {"by_span": by_span, "by_layer": by_layer}


def timeline_events(path: str) -> List[Dict[str, Any]]:
    """The complete events of a Chrome trace file that the idle attribution
    reads: device operations (kernels, copies, memsets) and host scopes
    (``record_function``), each as ``{cat, name, ts, dur}``."""
    keep = (*_DEVICE_OPS, _HOST_ANNOTATION)
    return [{"cat": e["cat"], "name": e.get("name", ""), "ts": float(e["ts"]), "dur": float(e["dur"])}
            for e in _load_trace_events(path)
            if e.get("ph") == "X" and e.get("cat") in keep and isinstance(e.get("dur"), (int, float))]


def _events(trace: Union[str, Sequence[Dict[str, Any]]]) -> List[Dict[str, Any]]:
    if isinstance(trace, str):
        return timeline_events(trace)
    return [e for e in trace if e.get("ph", "X") == "X" and isinstance(e.get("dur"), (int, float))]


def _merged(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _clock(anchor_ts: List[float], anchors: Sequence[Sequence[int]]) -> Tuple[Any, Optional[float]]:
    """``perf_counter_ns`` -> trace microseconds, from the anchors' scopes
    paired in order with the trace's anchor events; and the drift, how far the
    two clocks moved apart between the first anchor and the last (us).

    A read lags its scope's timestamp by the time the scope took to enter, so
    of an anchor's scopes the one with the largest ``ts - read`` is the
    truest; the map is exact at the first anchor's and the last's."""
    points, k = [], 0
    for reads in anchors:
        pairs = list(zip(reads, anchor_ts[k:k + len(reads)]))
        k += len(reads)
        if pairs:
            points.append(max(pairs, key=lambda pr: pr[1] - pr[0] / 1e3))
    if not points:
        raise ValueError("no clock anchor pairs: the trace has no anchor scope, or no anchors were noted")
    p0, t0 = points[0]
    if len(points) == 1:
        return (lambda ns: t0 + (ns - p0) / 1e3), None
    p1, t1 = points[-1]
    span_us = (p1 - p0) / 1e3
    rate = (t1 - t0) / span_us if span_us > 0 else 1.0
    return (lambda ns: t0 + (ns - p0) / 1e3 * rate), (t1 - t0) - span_us


def idle_attribution(trace: Union[None, str, Sequence[Dict[str, Any]]] = None,
                     records: Optional[Sequence[SpanRecord]] = None,
                     anchors: Optional[Sequence[Sequence[int]]] = None,
                     window: Union[None, str, Tuple[float, float]] = None,
                     thread_id: Optional[int] = None) -> Dict[str, Any]:
    """Put every device-idle interval of a profiled window down to the span
    the host was in.

    ``trace``: a Chrome trace of a :func:`~metrics_tpu_torch.observability.
    profiler.start_trace` session: its path, or its events.
    ``records``: the span records of the session (those of ``thread_id``
    alone when given: the host thread that drove the device). ``anchors``:
    the session's anchor reads, paired in order with the trace's anchor
    scopes; with two anchors, the map is exact at both and linear between.
    Each of the three defaults to the last stopped session's
    (:func:`~metrics_tpu_torch.observability.profiler.last_session`).
    ``window``: ``(start, end)`` on the trace's clock (us), or the name of a
    host scope, for the first such scope's start to the last one's end;
    default, from the first device operation or span to the last.

    Returns, over the window (ms):

    - ``window_ms`` and ``busy_ms``, the union of kernel, copy and memset
      intervals;
    - ``idle_ms``: ``by_span`` (the innermost span open on the host) and
      ``by_layer`` (:data:`LAYER_OF_SPAN`), both with ``outside`` for idle
      time in no span; they add up to ``window_ms - busy_ms``;
    - ``host_self_ms``: :func:`span_self_ms` of the spans that start in the
      window;
    - ``clock``: the anchors used, the drift between the clocks over the
      session (us), and the join of each span with its ``record_function``
      scope by name and mapped start (``joined`` of ``spans`` within
      :data:`JOIN_TOLERANCE_US`, and the widest distance of a join).
    """
    from metrics_tpu_torch.observability.profiler import ANCHOR, last_session

    if trace is None or records is None or anchors is None:
        session = last_session()
        if session is None:
            raise ValueError("no profiler session has stopped: pass the trace, the records and the anchors")
        trace = session.events if trace is None else trace
        records = session.records if records is None else records
        anchors = session.anchors if anchors is None else anchors

    events = _events(trace)
    ops = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events if e.get("cat") in _DEVICE_OPS]
    scopes: Dict[str, List[float]] = {}
    for e in events:
        if e.get("cat") == _HOST_ANNOTATION:
            scopes.setdefault(e.get("name", ""), []).append(float(e["ts"]))
    for starts in scopes.values():
        starts.sort()
    to_us, drift = _clock(scopes.get(ANCHOR, []), anchors)
    mapped = [(to_us(r.start_ns), to_us(r.end_ns), r) for r in records if thread_id is None or r.thread_id == thread_id]

    if isinstance(window, str):
        named = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in events
                 if e.get("cat") == _HOST_ANNOTATION and e.get("name") == window]
        if not named:
            raise ValueError(f"no host scope named {window!r} in the trace")
        window = (min(a for a, _ in named), max(b for _, b in named))
    if window is None:
        edges = [x for a, b in ops for x in (a, b)] + [x for a, b, _ in mapped for x in (a, b)]
        if not edges:
            raise ValueError("nothing to attribute: no device operation and no span")
        window = (min(edges), max(edges))
    w0, w1 = float(window[0]), float(window[1])

    busy = _merged([(max(a, w0), min(b, w1)) for a, b in ops if b > w0 and a < w1])
    segments = _innermost([(max(a, w0), min(b, w1), r) for a, b, r in mapped if b > w0 and a < w1], w0, w1)
    by_span: Dict[str, float] = {}
    by_layer: Dict[str, float] = {}
    for lo, hi, rec in _idle_pieces(segments, busy):
        name = rec.name if rec is not None else None
        by_span[name or "outside"] = by_span.get(name or "outside", 0.0) + (hi - lo) / 1e3
        by_layer[_layer(name)] = by_layer.get(_layer(name), 0.0) + (hi - lo) / 1e3
    joined, widest = _join(mapped, scopes)
    return {
        "window_ms": (w1 - w0) / 1e3,
        "busy_ms": sum(b - a for a, b in busy) / 1e3,
        "idle_ms": {"by_span": by_span, "by_layer": by_layer},
        "host_self_ms": span_self_ms([r for a, _, r in mapped if w0 <= a <= w1]),
        "clock": {"anchors": len(anchors), "drift_us": drift, "joined": joined, "spans": len(mapped),
                  "join_widest_us": widest},
    }


def _innermost(spans: List[Tuple[float, float, SpanRecord]], w0: float,
               w1: float) -> List[Tuple[float, float, Optional[SpanRecord]]]:
    """``[w0, w1]`` cut into segments ``(start, end, record)``, each with the
    deepest of ``spans`` open over it (None where none is): one sweep over the
    spans' edges."""
    marks = sorted([(a, 0, i) for i, (a, _, _) in enumerate(spans)] + [(b, 1, i) for i, (_, b, _) in enumerate(spans)])
    segments: List[Tuple[float, float, Optional[SpanRecord]]] = []
    open_: Dict[int, int] = {}
    t, j = w0, 0
    while True:
        nxt = marks[j][0] if j < len(marks) else w1
        if nxt > t:
            top = max(open_, key=open_.get) if open_ else None
            segments.append((t, nxt, spans[top][2] if top is not None else None))
            t = nxt
        if j == len(marks):
            return segments
        while j < len(marks) and marks[j][0] == nxt:  # every edge at this time before the next segment
            _, end, i = marks[j]
            if end:
                open_.pop(i, None)
            else:
                open_[i] = spans[i][2].depth
            j += 1


def _idle_pieces(segments: List[Tuple[float, float, Optional[SpanRecord]]],
                 busy: List[Tuple[float, float]]) -> Iterator[Tuple[float, float, Optional[SpanRecord]]]:
    """The parts of the host's segments (which cover the window) outside the
    merged ``busy`` intervals: two sorted lists walked together."""
    k = 0
    for lo, hi, rec in segments:
        while k < len(busy) and busy[k][1] <= lo:
            k += 1
        cursor, m = lo, k
        while cursor < hi:
            if m < len(busy) and busy[m][0] < hi:
                if busy[m][0] > cursor:
                    yield cursor, busy[m][0], rec
                cursor = max(cursor, busy[m][1])
                m += 1
            else:
                yield cursor, hi, rec
                cursor = hi


def _join(mapped: List[Tuple[float, float, SpanRecord]], scopes: Dict[str, List[float]]) -> Tuple[int, float]:
    """How many spans have a scope of their name within
    :data:`JOIN_TOLERANCE_US` of their mapped start, and the widest distance
    of such a join (us)."""
    joined, widest = 0, 0.0
    for a, _, r in mapped:
        starts = scopes.get(r.name, [])
        k = bisect.bisect_left(starts, a)
        near = min((abs(starts[j] - a) for j in (k - 1, k) if 0 <= j < len(starts)), default=None)
        if near is not None and near <= JOIN_TOLERANCE_US:
            joined += 1
            widest = max(widest, near)
    return joined, widest
