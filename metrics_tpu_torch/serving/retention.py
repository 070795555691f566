"""Tiered retention and the query plane: closed windows that outlive the ring.

Counterpart of ``metrics_tpu/serving/retention.py``. Every state kind the
window plane holds merges by an associative, commutative fold, so closed
windows roll up into coarser time grids without losing anything:

- **Banking.** :class:`RetentionStore` attaches to a
  :class:`~metrics_tpu_torch.serving.service.MetricService` (its
  ``partial_publish_fn`` tap) or a
  :class:`~metrics_tpu_torch.serving.fleet.MetricFleet` (its
  ``merged_partial_publish_fn`` tap) and banks each closed window's raw
  partial (:meth:`~metrics_tpu_torch.wrappers.windowed.Windowed.window_partial`:
  sum-backed host numpy leaves, ``PARTIAL_SCHEMA_VERSION`` 1). Partials of
  either package bank alike.
- **The resolution ladder.** Buckets live on ``(seconds, capacity)`` rungs,
  finest first. An overflowing rung merges its oldest bucket into the
  covering bucket of the next rung; the last rung evicts (counted). A
  rolled-up bucket equals the state a flat merge of its raw partials builds.
- **The query plane.** :meth:`RetentionStore.query` selects the buckets
  overlapping a time range, groups them on the output resolution, merges each
  group and only then finishes it through the stream's
  ``value_from_partials``. A resolution finer than a retained bucket raises.
- **final=.** Partials of windows ``finalize()`` force-published arrive
  ``final=False``, and every bucket and point they reach says so.
- **Consistency.** One lock covers banking, roll-up and reads, and a roll-up
  builds its merged bucket whole before installing it.

The merges run as torch ops on the stream's device (the template metric's);
banked buckets are host numpy. Gauges: the ``retention`` block of the
counters snapshot, enabled-gated.
"""
import itertools
import math
import threading
from typing import Any, Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from metrics_tpu_torch.observability.counters import record_retention, state_nbytes
from metrics_tpu_torch.observability.lifecycle import stamp as _lifecycle_stamp
from metrics_tpu_torch.parallel.slab import PARTIAL_SCHEMA_VERSION, check_partial_version
from metrics_tpu_torch.utils.data import host_copy, host_tree
from metrics_tpu_torch.wrappers.keyed import Keyed
from metrics_tpu_torch.wrappers.windowed import Windowed

__all__ = ["DEFAULT_LADDER_SHAPE", "RetentionRung", "RetentionStore"]

# the default ladder shape in window strides: (multiple of the previous rung's
# width, capacity); ``ladder=None`` scales it by the attached stream's stride
DEFAULT_LADDER_SHAPE = ((1, 16), (4, 16), (16, 16))


class RetentionRung(NamedTuple):
    """One rung of the ladder: buckets ``seconds`` wide, at most ``capacity``
    of them resident before the oldest rolls up (or, last rung, evicts)."""

    seconds: float
    capacity: int


def _normalize_ladder(ladder: Sequence[Tuple[float, int]]) -> Tuple[RetentionRung, ...]:
    rungs = []
    for entry in ladder:
        seconds, capacity = entry
        if not (isinstance(capacity, int) and capacity >= 1):
            raise ValueError(f"rung capacity must be a positive int, got {capacity!r}")
        seconds = float(seconds)
        if not (seconds > 0):
            raise ValueError(f"rung seconds must be > 0, got {seconds!r}")
        rungs.append(RetentionRung(seconds, capacity))
    if not rungs:
        raise ValueError("the resolution ladder needs at least one rung")
    for prev, nxt in zip(rungs, rungs[1:]):
        ratio = nxt.seconds / prev.seconds
        if abs(ratio - round(ratio)) > 1e-9 or round(ratio) < 2:
            raise ValueError(
                "each rung's bucket width must be an integer multiple (>= 2x) of"
                f" the previous rung's; got {prev.seconds}s -> {nxt.seconds}s"
            )
    return tuple(rungs)


class _RetainedStream:
    """One attached stream's banked state: the finisher template and one
    ``{bucket index: bucket}`` dict a rung. A bucket is a mergeable partial
    with retention metadata (``start_s`` / ``end_s`` / ``windows`` /
    ``final``)."""

    __slots__ = ("label", "template", "ladder", "rungs", "evicted_buckets")

    def __init__(self, label: str, template: Windowed, ladder: Tuple[RetentionRung, ...]):
        stride = template.window_stride
        if abs(ladder[0].seconds - stride) > 1e-9:
            raise ValueError(
                f"the ladder's base rung is the raw window grid: rung 0 must be"
                f" {stride}s wide (the stream's window stride), got"
                f" {ladder[0].seconds}s"
            )
        self.label = label
        self.template = template
        self.ladder = ladder
        self.rungs: Tuple[Dict[int, Dict[str, Any]], ...] = tuple({} for _ in ladder)
        self.evicted_buckets = 0

    def resident_bytes(self) -> int:
        total = 0
        for rung in self.rungs:
            for bucket in rung.values():
                total += state_nbytes(bucket["state"]) + state_nbytes(bucket["rows"])
        return total


class RetentionStore:
    """Banked closed windows on a resolution ladder, and the query plane.

    Args:
        ladder: ``(seconds, capacity)`` rungs, finest first. Rung 0 must equal
            the attached stream's window stride; each coarser width an integer
            multiple (>= 2) of the previous. ``None`` scales
            :data:`DEFAULT_LADDER_SHAPE` by the stream's stride.
        name: the gauge label (auto-indexed when omitted).

    One store may retain several streams; queries name them by label, or omit
    ``metric=`` when one is attached.
    """

    _ids = itertools.count()

    def __init__(
        self,
        ladder: Optional[Sequence[Tuple[float, int]]] = None,
        name: Optional[str] = None,
    ):
        self._ladder_cfg = None if ladder is None else _normalize_ladder(ladder)
        self.label = name or f"RetentionStore#{next(RetentionStore._ids)}"
        self._lock = threading.RLock()
        self._streams: Dict[str, _RetainedStream] = {}
        self.windows_banked = 0  # lifetime raw window partials banked
        self.rollups = 0  # lifetime roll-up merges performed
        self.queries = 0  # lifetime query-plane reads

    # ------------------------------------------------------------ attaching
    def attach(self, source: Any) -> "RetentionStore":
        """Subscribe to a service's or a fleet's closed-window partials. The
        tap composes with a callback already installed there. Returns
        ``self``."""
        from metrics_tpu_torch.serving.fleet import MetricFleet
        from metrics_tpu_torch.serving.service import MetricService

        if isinstance(source, MetricFleet):
            label = source.label
            self._register(label, source._template)
            prev = source.merged_partial_publish_fn

            def fleet_tap(record: Dict[str, Any], partial: Dict[str, Any]) -> None:
                if prev is not None:
                    prev(record, partial)
                self.ingest(label, partial)

            source.merged_partial_publish_fn = fleet_tap
        elif isinstance(source, MetricService):
            label = source.label
            self._register(label, source.metric)
            prev = source.partial_publish_fn

            def service_tap(record: Dict[str, Any], partial: Dict[str, Any]) -> None:
                if prev is not None:
                    prev(record, partial)
                self.ingest(label, partial)

            source.partial_publish_fn = service_tap
        else:
            raise ValueError(
                "RetentionStore.attach takes a MetricService or a MetricFleet,"
                f" got {type(source).__name__}"
            )
        return self

    def _register(self, label: str, template: Windowed) -> _RetainedStream:
        if not isinstance(template, Windowed) or template.decay:
            raise ValueError(
                "retention banks per-window partials; the stream's metric must"
                " be a Windowed ring"
            )
        ladder = self._ladder_cfg
        if ladder is None:
            stride = template.window_stride
            ladder = _normalize_ladder(
                [(stride * mult, cap) for mult, cap in DEFAULT_LADDER_SHAPE]
            )
        with self._lock:
            if label in self._streams:
                raise ValueError(
                    f"a stream labeled {label!r} is already retained by this store"
                )
            stream = _RetainedStream(label, template, ladder)
            self._streams[label] = stream
            return stream

    @property
    def labels(self) -> tuple:
        """The attached stream labels, sorted."""
        with self._lock:
            return tuple(sorted(self._streams))

    # -------------------------------------------------------------- banking
    def ingest(self, label: str, partial: Dict[str, Any]) -> None:
        """Bank one published window partial (the tap target; callable
        directly when partials cross a process boundary). Validates the wire
        version, banks at rung 0 and compacts the ladder. A re-published
        window replaces its bucket."""
        check_partial_version(partial)
        window = int(partial["window"])
        with self._lock:
            stream = self._streams.get(label)
            if stream is None:
                raise KeyError(
                    f"no retained stream labeled {label!r} (attached:"
                    f" {sorted(self._streams)})"
                )
            stride = stream.ladder[0].seconds
            start_s = float(partial.get("window_start_s", window * stride))
            bucket = {
                "version": PARTIAL_SCHEMA_VERSION,
                "window": window,
                "rows": np.asarray(partial["rows"]),
                "state": dict(partial["state"]),
                # the true covered span, not the rung's nominal grid cell
                "start_s": start_s,
                "end_s": start_s + stride,
                "windows": 1,
                "final": bool(partial.get("final", True)),
            }
            stream.rungs[0][window] = bucket
            self.windows_banked += 1
            self._compact_locked(stream)
            self._note_gauges_locked()
        # after the store lock: the ledger takes its own and must not nest in it
        _lifecycle_stamp(label, window, "banked")

    def _compact_locked(self, stream: _RetainedStream) -> None:
        """Enforce every rung's capacity, oldest first: an overflowing bucket
        merges into the covering cell one rung coarser (keyed by
        ``floor(start / rung seconds)``), the last rung evicts."""
        for i, rung_cfg in enumerate(stream.ladder):
            buckets = stream.rungs[i]
            while len(buckets) > rung_cfg.capacity:
                oldest = buckets.pop(min(buckets))
                if i + 1 < len(stream.ladder):
                    coarser = stream.ladder[i + 1]
                    target = int(math.floor(oldest["start_s"] / coarser.seconds + 1e-9))
                    existing = stream.rungs[i + 1].get(target)
                    merged = (
                        oldest if existing is None
                        else self._merge_buckets(stream, existing, oldest)
                    )
                    stream.rungs[i + 1][target] = merged
                    self.rollups += 1
                else:
                    stream.evicted_buckets += 1

    @staticmethod
    def _merge_buckets(
        stream: _RetainedStream, a: Dict[str, Any], b: Dict[str, Any]
    ) -> Dict[str, Any]:
        inner, rows = stream.template.merge_partials([a, b])
        return {
            "version": PARTIAL_SCHEMA_VERSION,
            "window": min(int(a["window"]), int(b["window"])),
            "rows": host_copy(rows),
            "state": host_tree(inner),
            "start_s": min(a["start_s"], b["start_s"]),
            "end_s": max(a["end_s"], b["end_s"]),
            "windows": int(a["windows"]) + int(b["windows"]),
            "final": bool(a["final"]) and bool(b["final"]),
        }

    # -------------------------------------------------------------- reading
    def _resolve_stream(self, metric: Optional[str]) -> _RetainedStream:
        if metric is None:
            if len(self._streams) != 1:
                raise ValueError(
                    "metric= is required when the store retains"
                    f" {len(self._streams)} streams (attached:"
                    f" {sorted(self._streams)})"
                )
            return next(iter(self._streams.values()))
        stream = self._streams.get(metric)
        if stream is None:
            raise KeyError(
                f"no retained stream labeled {metric!r} (attached:"
                f" {sorted(self._streams)})"
            )
        return stream

    @staticmethod
    def _finish(stream: _RetainedStream, buckets: List[Dict[str, Any]], tenant: Optional[int]) -> Any:
        """Merged buckets finished once and read to the host, sliced by tenant slot."""
        value = host_tree(stream.template.value_from_partials(buckets))
        if tenant is None:
            return value
        inner = stream.template.metric
        if not isinstance(inner, Keyed):
            raise ValueError(
                f"stream {stream.label!r} has no tenant axis (its inner metric"
                f" is {type(inner).__name__}, not Keyed)"
            )
        if inner.lru:
            raise ValueError(
                "per-tenant retention reads need stable slot ids"
                " (Keyed(lru=False)); an LRU slab's rows are not addressable"
                " across windows"
            )
        slot = int(tenant)
        if not (0 <= slot < inner.num_slots):
            raise KeyError(
                f"tenant slot {slot} is out of range [0, {inner.num_slots})"
            )
        return _slice(value, slot)

    def query(
        self,
        metric: Optional[str] = None,
        tenant: Optional[int] = None,
        time_range: Optional[Tuple[float, float]] = None,
        resolution_s: Optional[float] = None,
    ) -> List[Dict[str, Any]]:
        """Finished values over banked windows, on an output grid.

        Args:
            metric: the stream's label (omit when one stream is retained).
            tenant: for ``Windowed(Keyed(...))`` streams, the tenant slot to
                slice the finished values by; ``None`` returns the whole value.
            time_range: ``(start_s, end_s)`` in event time, half-open.
            resolution_s: the output grid; every retained bucket in range must
                nest inside one output bucket (finer than retained raises).
                ``None`` returns each retained bucket as its own point.

        Returns points oldest first: ``{"start_s", "seconds", "value",
        "windows", "rows", "final"}``; ``[]`` for an empty range.
        """
        if time_range is None:
            raise ValueError("query needs time_range=(start_s, end_s)")
        start_s, end_s = (float(time_range[0]), float(time_range[1]))
        if not (end_s >= start_s):
            raise ValueError(f"time_range end {end_s} precedes start {start_s}")
        with self._lock:
            stream = self._resolve_stream(metric)
            self.queries += 1
            selected = [
                bucket
                for rung in stream.rungs
                for bucket in rung.values()
                if bucket["start_s"] < end_s and bucket["end_s"] > start_s
            ] if end_s > start_s else []  # [t, t) is empty, not a point read
            points: List[Dict[str, Any]] = []
            if selected:
                groups: Dict[float, List[Dict[str, Any]]] = {}
                if resolution_s is None:
                    for bucket in selected:
                        groups.setdefault(bucket["start_s"], []).append(bucket)
                    widths = {
                        b["start_s"]: b["end_s"] - b["start_s"] for b in selected
                    }
                else:
                    res = float(resolution_s)
                    if not res > 0:
                        raise ValueError(f"resolution_s must be > 0, got {res!r}")
                    widths = {}
                    for bucket in selected:
                        lo = math.floor(bucket["start_s"] / res + 1e-9)
                        hi = math.ceil(bucket["end_s"] / res - 1e-9)
                        if hi - lo != 1:
                            raise ValueError(
                                f"resolution {res}s cannot split the retained"
                                f" bucket covering [{bucket['start_s']}s,"
                                f" {bucket['end_s']}s) — rolled-up state"
                                " only merges coarser, never finer"
                            )
                        key = lo * res
                        groups.setdefault(key, []).append(bucket)
                        widths[key] = res
                for key in sorted(groups):
                    group = groups[key]
                    points.append({
                        "start_s": key,
                        "seconds": widths[key],
                        "value": np.asarray(self._finish(stream, group, tenant)),
                        "windows": sum(int(b["windows"]) for b in group),
                        "rows": float(np.asarray(sum(float(np.asarray(b["rows"]).sum()) for b in group))),
                        "final": all(bool(b["final"]) for b in group),
                    })
            self._note_gauges_locked()
            return points

    def latest(
        self, metric: Optional[str] = None, tenant: Optional[int] = None
    ) -> Optional[Dict[str, Any]]:
        """The newest retained bucket's finished value (what the OpenMetrics
        endpoint renders), or ``None`` before anything banked."""
        with self._lock:
            stream = self._resolve_stream(metric)
            newest: Optional[Dict[str, Any]] = None
            for rung in stream.rungs:
                for bucket in rung.values():
                    if newest is None or bucket["start_s"] > newest["start_s"]:
                        newest = bucket
            if newest is None:
                return None
            self.queries += 1
            point = {
                "start_s": newest["start_s"],
                "seconds": newest["end_s"] - newest["start_s"],
                "value": np.asarray(self._finish(stream, [newest], tenant)),
                "windows": int(newest["windows"]),
                "final": bool(newest["final"]),
            }
            self._note_gauges_locked()
            return point

    # ---------------------------------------------------------------- gauges
    def resident_bytes(self, metric: Optional[str] = None) -> int:
        """Banked-state bytes of one stream or the whole store, bounded by the
        ladder's shape, not by the stream's length."""
        with self._lock:
            if metric is not None:
                return self._resolve_stream(metric).resident_bytes()
            return sum(s.resident_bytes() for s in self._streams.values())

    @property
    def evicted_buckets(self) -> int:
        """Buckets aged past the last rung and dropped (counted)."""
        with self._lock:
            return sum(s.evicted_buckets for s in self._streams.values())

    def _note_gauges_locked(self) -> None:
        resident = sum(s.resident_bytes() for s in self._streams.values())
        record_retention(
            self.label, self.windows_banked, self.rollups, resident, self.queries
        )

    def __repr__(self) -> str:
        with self._lock:
            return (
                f"RetentionStore({self.label!r}, streams={sorted(self._streams)},"
                f" banked={self.windows_banked}, rollups={self.rollups})"
            )


def _slice(value: Any, slot: int) -> Any:
    """Row ``slot`` of every array of a host value tree."""
    if isinstance(value, dict):
        return {k: _slice(v, slot) for k, v in value.items()}
    if isinstance(value, tuple) and hasattr(value, "_fields"):
        return type(value)(*(_slice(v, slot) for v in value))
    if isinstance(value, (list, tuple)):
        return type(value)(_slice(v, slot) for v in value)
    return np.asarray(value)[slot]
