"""Counters of the sync planes, the keyed wrappers and the watermark agreement.

Counterpart of the collective, slab, watermark, fault, deferred and sparse
parts of ``metrics_tpu/observability/counters.py``: the
:class:`CollectiveCounters` registry, ``enable`` / ``disable`` /
``is_enabled`` / ``reset`` / ``snapshot``, and the record functions the sync
planes (``parallel/sync.py``, ``parallel/buffer.py``, ``parallel/sparse.py``,
``parallel/deferred.py``), the wrappers and
``core/streaming.WatermarkAgreement`` call. What is counted:

- **collectives**: every collective a sync plane enters, at its issue site
  (a retry that enters it again counts again), while counting is enabled:
  ``calls_by_kind`` and ``bytes_by_kind_dtype`` (the local payload entering
  it) under the JAX package's kind names (``psum`` / ``pmin`` / ``pmax`` for
  ``all_reduce`` by its op, ``all_gather``, ``process_allgather`` for the
  host plane's gathers), and ``calls_by_crossing`` / ``bytes_by_crossing``
  over ``ici`` / ``dcn`` / ``world``. Per-crossing bytes are ring traffic,
  ``payload * (fanout - 1)`` for a collective over ``fanout`` ranks (the
  payload alone when the fanout is unknown or 1): a flat sum over W ranks
  costs ``p * (W - 1)`` at ``world``, the two-stage sum of a hierarchy of S
  slices of L ranks ``p * (L - 1)`` at ``ici`` and ``p * (S - 1)`` at
  ``dcn``. ``collective_calls`` / ``sync_bytes`` are the totals.
- **states_synced**: state leaves entering a sync plane, while counting is
  enabled.
- **sparse**: the sparse plane's round ledger ``{syncs, rows, fallbacks,
  skips}`` (:data:`SPARSE_KINDS`): rounds run, union rows exchanged, rounds
  that overflowed the capacity and ran the dense plane, and empty rounds
  that entered no row exchange (each also a ``gather_skips``). Recorded even
  while counting is disabled: a fallback is evidence that the capacity
  estimate broke.

- **slab_dropped_samples**: samples whose slot id fell outside a slab's
  ``[0, K)`` range and were dropped by the scatter (``parallel/slab.py``).
  Recorded even while counting is disabled: a sample that vanished must leave
  a trail. The drop is decided from the ids on the host, a read the update
  pays anyway.
- **evicted_mass_dropped**: samples whose accumulated history a
  ``Keyed(lru=True)`` eviction destroyed (the recycled slot's row count when
  it was zeroed). Recorded even while counting is disabled. ``HeavyHitters``
  folds a demoted row into its count-min tail instead, and leaves it zero.
- **slab_slots**: per-wrapper gauges ``{label: {"slots": K, "occupied": n,
  "evictions": e}}``, refreshed after every keyed update while counting is
  enabled.
- **heavy_hitters**: per-wrapper gauges ``{label: {"hot_slots",
  "hot_occupied", "promotions", "demotions", "tail_mass", "tail_bound"}}``
  from the space-saving table's host bookkeeping (no device read), refreshed
  after every update while counting is enabled.
- **wm_stragglers**: ranks excluded from a ``WatermarkAgreement`` because
  their watermark stalled past its ``deadline_s``; one per exclusion episode.
  Recorded even while counting is disabled: an excluded rank's events are
  judged by a clock it no longer feeds.
- **wm_exchange_calls**: watermark exchange rounds dispatched, while counting
  is enabled.
- **watermark_agreement**: per-agreement gauges ``{label: {"agreed",
  "ranks", "excluded", "exchanges"}}``, refreshed on every exchange and every
  exclusion or rejoin while counting is enabled.

- **faults**: ``{kind: n}`` over :data:`FAULT_KINDS` (guarded collective
  retries, exhausted retry budgets, degraded syncs, quarantined updates).
  Recorded even while counting is disabled: fault evidence must survive.
- **gather_skips**: host-plane syncs of an empty (or all-``None``) state that
  entered no collective. Recorded even while counting is disabled.
- **deferred**: ``{kind: n}`` over :data:`DEFERRED_KINDS` (handles
  dispatched, fenced by ``result()``, completed), while counting is enabled.
- **deferred_depth**: per-label gauges ``{label: {"current", "max"}}`` of a
  metric's lag-k handle ring, refreshed by every deferring forward while
  counting is enabled.

- **state_bytes**: a per-metric gauge ``{metric label: bytes}`` of the
  current state footprint (:func:`state_nbytes`), refreshed after every
  update and sync while counting is enabled (``Metric._note_state_bytes``).
- **lifecycle** / **watermark_lag** / **publish_staleness** / **selfmeter**:
  the health plane's gauges, fed by ``observability/lifecycle.py`` as a
  window's ledger reaches ``published`` (``publish_staleness`` is derived at
  snapshot time from the last publish stamp, so it keeps aging between
  publishes), while counting is enabled.
- **service_health** / **retention** / **fleet_shards**: the serving
  runtime's gauges, with the JAX package's layouts. ``service_health``
  records even while counting is disabled, as there.
- **Cache traffic** as ``{"hits", "misses"}`` pairs: ``group_cache`` counts
  the compute-group map's lookups (``MetricCollection._group_map``: a miss
  builds the map). ``step_cache``, ``fused_step_cache``, ``launch_cache`` and
  ``ingest_program_cache`` name the JAX package's jitted-program caches; the
  port compiles no program (ROADMAP section 1, left out for good), so they
  stay 0, and stay in every snapshot so both packages' snapshots carry the
  same keys.

``snapshot()`` carries every key of the JAX package's snapshot, with its names
and layouts. Counting is off by default; all mutation happens under one lock.
"""
import threading
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

__all__ = [
    "COUNTERS",
    "CollectiveCounters",
    "DEFERRED_KINDS",
    "FAULT_KINDS",
    "SPARSE_KINDS",
    "disable",
    "enable",
    "is_enabled",
    "record_cache",
    "record_collective",
    "record_deferred",
    "record_deferred_depth",
    "record_evicted_mass",
    "record_fault",
    "record_fleet_shards",
    "record_gather_skip",
    "record_heavy_hitters",
    "record_lifecycle",
    "record_publish_stamp",
    "record_retention",
    "record_selfmeter",
    "record_service_health",
    "record_slab_dropped",
    "record_slab_slots",
    "record_sparse_fallback",
    "record_sparse_round",
    "record_sparse_skip",
    "record_state_bytes",
    "record_states_synced",
    "record_watermark_agreement",
    "record_watermark_lag",
    "record_wm_exchange",
    "record_wm_straggler",
    "reset",
    "snapshot",
    "state_nbytes",
]

# fault-counter kinds with a stable place in every snapshot (zeros included)
FAULT_KINDS = (
    "sync_retries",  # guarded collective attempts made again after a transient failure
    "sync_deadline_exceeded",  # retry budgets exhausted (either policy)
    "degraded_computes",  # syncs that fell back to the local state
    "quarantined_updates",  # batch deltas discarded by check_finite="quarantine"
)

# deferred-plane lifecycle counters (parallel/deferred.py), all three in every snapshot
DEFERRED_KINDS = (
    "dispatched",  # SyncHandles issued (collectives entered unfenced / host gathers queued)
    "fenced",  # handles resolved by result()
    "completed",  # syncs whose work finished
)

# the sparse plane's round ledger (parallel/sparse.py), all four in every snapshot
SPARSE_KINDS = (
    "syncs",  # sparse rounds run (every mode: exchange, fallback, skip)
    "rows",  # union rows exchanged, summed over rounds
    "fallbacks",  # rounds whose union overflowed the capacity and ran the dense plane
    "skips",  # empty-union rounds that entered no row exchange
)

# collective kinds in their snapshot order (the JAX package's names)
KINDS = ("psum", "pmean", "pmin", "pmax", "all_gather", "coalesced_gather", "ppermute", "all_to_all",
         "process_allgather")

# the cache pairs of every snapshot, the JAX package's names; only "group" has
# a cache in the port (the others name jitted-program caches, and stay 0)
CACHES = ("group", "step", "launch", "fused_step", "ingest_program")


class CollectiveCounters:
    """Process-wide counters; ``enabled`` is the gate of the gauges."""

    __slots__ = ("enabled", "calls_by_kind", "bytes_by_kind_dtype", "calls_by_crossing", "bytes_by_crossing",
                 "states_synced", "slab_dropped_samples", "evicted_mass_dropped", "slab_slots", "heavy_hitters",
                 "wm_stragglers", "wm_exchange_calls", "watermark_agreement", "faults", "gather_skips",
                 "deferred", "deferred_depth", "sparse", "caches", "fleet_shards", "state_bytes", "service_health",
                 "retention", "lifecycle", "watermark_lag", "publish_stamp_ns", "selfmeter", "_lock")

    def __init__(self) -> None:
        self.enabled = False
        self._lock = threading.Lock()
        self._zero()

    def _zero(self) -> None:
        self.calls_by_kind: Dict[str, int] = {}
        self.bytes_by_kind_dtype: Dict[tuple, int] = {}  # (kind, dtype name) -> payload bytes
        self.calls_by_crossing: Dict[str, int] = {}  # "ici" | "dcn" | "world" -> calls
        self.bytes_by_crossing: Dict[str, int] = {}  # crossing -> ring traffic bytes
        self.states_synced = 0
        self.slab_dropped_samples = 0
        self.evicted_mass_dropped = 0
        self.slab_slots: Dict[str, Dict[str, int]] = {}
        self.heavy_hitters: Dict[str, Dict[str, Any]] = {}
        self.wm_stragglers = 0
        self.wm_exchange_calls = 0
        self.watermark_agreement: Dict[str, Dict[str, Any]] = {}
        self.faults: Dict[str, int] = {k: 0 for k in FAULT_KINDS}
        self.gather_skips = 0
        self.deferred: Dict[str, int] = {k: 0 for k in DEFERRED_KINDS}
        self.deferred_depth: Dict[str, Dict[str, int]] = {}
        self.sparse: Dict[str, int] = {k: 0 for k in SPARSE_KINDS}
        self.caches: Dict[str, Dict[str, int]] = {c: {"hits": 0, "misses": 0} for c in CACHES}
        self.fleet_shards: Dict[str, Dict[str, Dict[str, Any]]] = {}  # fleet label -> shard gauges
        self.state_bytes: Dict[str, int] = {}  # metric label -> latest bytes
        self.service_health: Dict[str, Dict[str, Any]] = {}
        self.retention: Dict[str, Dict[str, int]] = {}
        self.lifecycle: Dict[str, Dict[str, Any]] = {}  # label -> window-ledger gauges
        self.watermark_lag: Dict[str, Dict[str, Any]] = {}  # label -> {"lag_s", "degraded"}
        self.publish_stamp_ns: Dict[str, int] = {}  # label -> last publish (perf_counter_ns)
        self.selfmeter: Dict[str, Dict[str, Dict[str, float]]] = {}  # label -> stage -> summary

    def record_collective(self, kind: str, value: Any, crossing: str = "world", fanout: Optional[int] = None) -> None:
        """Count one collective of ``kind`` whose local payload is ``value`` (a
        tensor, or a list of tensors moved by one call: dtype ``packed``);
        ``fanout`` ranks take part, so it moves ``payload * (fanout - 1)``
        bytes over ``crossing``."""
        parts = value if isinstance(value, (list, tuple)) else [value]
        nbytes = sum(int(v.numel()) * int(v.element_size()) for v in parts)
        dtype = "packed" if isinstance(value, (list, tuple)) else str(value.dtype).replace("torch.", "")
        traffic = nbytes * max(int(fanout) - 1, 1) if fanout else nbytes
        with self._lock:
            self.calls_by_kind[kind] = self.calls_by_kind.get(kind, 0) + 1
            self.bytes_by_kind_dtype[(kind, dtype)] = self.bytes_by_kind_dtype.get((kind, dtype), 0) + nbytes
            self.calls_by_crossing[crossing] = self.calls_by_crossing.get(crossing, 0) + 1
            self.bytes_by_crossing[crossing] = self.bytes_by_crossing.get(crossing, 0) + traffic

    def record_states_synced(self, n: int) -> None:
        with self._lock:
            self.states_synced += int(n)

    def record_sparse_round(self, rows: int) -> None:
        """Count one sparse round and the union rows it exchanged (0 on a skip)."""
        if rows < 0:
            raise ValueError(f"sparse union row count must be >= 0, got {rows}")
        with self._lock:
            self.sparse["syncs"] += 1
            self.sparse["rows"] += int(rows)

    def record_sparse_fallback(self) -> None:
        with self._lock:
            self.sparse["fallbacks"] += 1

    def record_sparse_skip(self) -> None:
        with self._lock:
            self.sparse["skips"] += 1

    def record_fault(self, kind: str, n: int = 1) -> None:
        """``kind`` must be in :data:`FAULT_KINDS` (a typo'd fault kind fails loudly)."""
        if kind not in self.faults:
            raise ValueError(f"unknown fault kind {kind!r}; expected one of {FAULT_KINDS}")
        with self._lock:
            self.faults[kind] += int(n)

    def record_deferred(self, kind: str, n: int = 1) -> None:
        """``kind`` must be in :data:`DEFERRED_KINDS` (fails loudly on a typo)."""
        if kind not in self.deferred:
            raise ValueError(f"unknown deferred kind {kind!r}; expected one of {DEFERRED_KINDS}")
        with self._lock:
            self.deferred[kind] += int(n)

    def record_deferred_depth(self, label: str, current: int) -> None:
        """Refresh one handle ring's depth gauge (latest ``current`` wins;
        ``max`` is the high-water mark since the last reset)."""
        if current < 0:
            raise ValueError(f"deferred depth must be >= 0, got {current}")
        with self._lock:
            prev = self.deferred_depth.get(label)
            peak = max(int(current), prev["max"]) if prev else int(current)
            self.deferred_depth[label] = {"current": int(current), "max": peak}

    def record_gather_skip(self) -> None:
        with self._lock:
            self.gather_skips += 1

    def record_slab_dropped(self, n: int = 1) -> None:
        """Count samples dropped by a slab scatter's out-of-range slot ids."""
        if n < 0:
            raise ValueError(f"dropped-sample count must be >= 0, got {n}")
        with self._lock:
            self.slab_dropped_samples += int(n)

    def record_evicted_mass(self, n: int) -> None:
        """Count samples whose history an LRU slot eviction destroyed."""
        if n < 0:
            raise ValueError(f"evicted-mass count must be >= 0, got {n}")
        with self._lock:
            self.evicted_mass_dropped += int(n)

    def record_wm_straggler(self, n: int = 1) -> None:
        """Count watermark-agreement exclusion episodes."""
        if n < 0:
            raise ValueError(f"straggler count must be >= 0, got {n}")
        with self._lock:
            self.wm_stragglers += int(n)

    def record_wm_exchange(self, n: int = 1) -> None:
        """Count watermark exchange rounds dispatched."""
        with self._lock:
            self.wm_exchange_calls += int(n)

    def record_watermark_agreement(self, label: str, agreed: Any, ranks: int, excluded: Any, exchanges: int) -> None:
        """Refresh one watermark agreement's gauges (latest value wins)."""
        with self._lock:
            self.watermark_agreement[label] = {
                "agreed": None if agreed is None else float(agreed),
                "ranks": int(ranks),
                "excluded": sorted(str(r) for r in excluded),
                "exchanges": int(exchanges),
            }

    def record_slab_slots(self, label: str, slots: int, occupied: int, evictions: int) -> None:
        """Refresh one keyed slab's slot gauges (latest value wins)."""
        with self._lock:
            self.slab_slots[label] = {"slots": int(slots), "occupied": int(occupied), "evictions": int(evictions)}

    def record_heavy_hitters(self, label: str, hot_slots: int, hot_occupied: int, promotions: int,
                             demotions: int, tail_mass: int, tail_bound: float) -> None:
        """Refresh one heavy-hitter wrapper's tier gauges (latest value wins)."""
        with self._lock:
            self.heavy_hitters[label] = {
                "hot_slots": int(hot_slots),
                "hot_occupied": int(hot_occupied),
                "promotions": int(promotions),
                "demotions": int(demotions),
                "tail_mass": int(tail_mass),
                "tail_bound": float(tail_bound),
            }

    def record_cache(self, which: str, hit: bool) -> None:
        """One lookup of cache ``which`` (one of :data:`CACHES`)."""
        if which not in self.caches:
            raise ValueError(f"unknown cache {which!r}; expected one of {CACHES}")
        with self._lock:
            self.caches[which]["hits" if hit else "misses"] += 1

    def record_service_health(self, label: str, state: str, shed_events: int, published: int,
                              queue_depth: int) -> None:
        """Refresh one serving loop's health gauges (latest value wins)."""
        with self._lock:
            self.service_health[label] = {"state": str(state), "shed_events": int(shed_events),
                                          "published": int(published), "queue_depth": int(queue_depth)}

    def record_retention(self, label: str, windows_banked: int, rollups: int, resident_bytes: int,
                         queries: int) -> None:
        """Refresh one retention store's gauges (latest value wins)."""
        with self._lock:
            self.retention[label] = {"windows_banked": int(windows_banked), "rollups": int(rollups),
                                     "resident_bytes": int(resident_bytes), "queries": int(queries)}

    def record_lifecycle(self, label: str, windows_stamped: int, open_windows: int, e2e_ms: float) -> None:
        """Refresh one label's window-lifecycle gauges (latest value wins)."""
        if windows_stamped < 0 or open_windows < 0:
            raise ValueError(
                f"lifecycle window counts must be >= 0, got ({windows_stamped}, {open_windows})"
            )
        with self._lock:
            self.lifecycle[label] = {"windows_stamped": int(windows_stamped), "open_windows": int(open_windows),
                                     "e2e_ms": float(e2e_ms)}

    def record_watermark_lag(self, label: str, lag_s: float, degraded: bool) -> None:
        """Refresh one label's watermark-lag gauge (latest value wins; a
        negative lag is surfaced, not clamped)."""
        with self._lock:
            self.watermark_lag[label] = {"lag_s": float(lag_s), "degraded": bool(degraded)}

    def record_publish_stamp(self, label: str, ns: int) -> None:
        """Refresh one label's last-publish stamp (``perf_counter_ns``)."""
        with self._lock:
            self.publish_stamp_ns[label] = int(ns)

    def record_selfmeter(self, label: str, stage: str, summary: Dict[str, float]) -> None:
        """Refresh one (label, stage) latency-sketch summary (latest wins)."""
        with self._lock:
            self.selfmeter.setdefault(label, {})[stage] = dict(summary)

    def record_fleet_shards(self, label: str, shards: Dict[Any, Dict[str, Any]]) -> None:
        """Refresh one serving fleet's per-shard gauges (latest value wins)."""
        with self._lock:
            self.fleet_shards[label] = {str(k): dict(v) for k, v in shards.items()}

    def record_state_bytes(self, metric: str, nbytes: int) -> None:
        """Refresh the per-metric state-footprint gauge (latest value wins)."""
        with self._lock:
            self.state_bytes[metric] = int(nbytes)

    def snapshot(self) -> Dict[str, Any]:
        """A JSON-ready copy of every counter."""
        now_ns = time.perf_counter_ns()  # staleness ages on the stamp clock
        with self._lock:
            calls = dict(self.calls_by_kind)
            by_bucket = dict(self.bytes_by_kind_dtype)
            return {
                "collective_calls": sum(calls.values()),
                "sync_bytes": sum(by_bucket.values()),
                "calls_by_kind": {k: calls[k] for k in KINDS if calls.get(k, 0)},
                "bytes_by_kind_dtype": {f"{k}:{d}": b for (k, d), b in sorted(by_bucket.items())},
                "calls_by_crossing": dict(sorted(self.calls_by_crossing.items())),
                "bytes_by_crossing": dict(sorted(self.bytes_by_crossing.items())),
                "states_synced": self.states_synced,
                "sparse": dict(self.sparse),
                "slab_dropped_samples": self.slab_dropped_samples,
                "evicted_mass_dropped": self.evicted_mass_dropped,
                "wm_stragglers": self.wm_stragglers,
                "wm_exchange_calls": self.wm_exchange_calls,
                "watermark_agreement": {k: dict(v) for k, v in sorted(self.watermark_agreement.items())},
                "slab_slots": {k: dict(v) for k, v in sorted(self.slab_slots.items())},
                "heavy_hitters": {k: dict(v) for k, v in sorted(self.heavy_hitters.items())},
                "faults": dict(self.faults),
                "gather_skips": self.gather_skips,
                "deferred": dict(self.deferred),
                "deferred_depth": {k: dict(v) for k, v in sorted(self.deferred_depth.items())},
                "state_bytes": dict(sorted(self.state_bytes.items())),
                "fleet_shards": {k: {s_: dict(g) for s_, g in sorted(v.items())}
                                 for k, v in sorted(self.fleet_shards.items())},
                "service_health": {k: dict(v) for k, v in sorted(self.service_health.items())},
                "retention": {k: dict(v) for k, v in sorted(self.retention.items())},
                "lifecycle": {k: dict(v) for k, v in sorted(self.lifecycle.items())},
                "watermark_lag": {k: dict(v) for k, v in sorted(self.watermark_lag.items())},
                "publish_staleness": {k: {"staleness_s": max(now_ns - ns, 0) / 1e9}
                                      for k, ns in sorted(self.publish_stamp_ns.items())},
                "selfmeter": {k: {s_: dict(row) for s_, row in sorted(v.items())}
                              for k, v in sorted(self.selfmeter.items())},
                **{f"{c}_cache": dict(self.caches[c]) for c in CACHES},
            }

    def reset(self) -> None:
        with self._lock:
            self._zero()


COUNTERS = CollectiveCounters()


# evidence of lost samples records unconditionally: a sample that vanished
# from a slab, or a tenant's destroyed history, must leave a trail even when
# counting is off
def record_slab_dropped(n: int = 1) -> None:
    COUNTERS.record_slab_dropped(n)


def record_evicted_mass(n: int) -> None:
    COUNTERS.record_evicted_mass(n)


def record_wm_straggler(n: int = 1) -> None:
    COUNTERS.record_wm_straggler(n)


# fault evidence records unconditionally too: faults are rare, never the hot
# path, and losing the trail because counting was off would defeat it
def record_fault(kind: str, n: int = 1) -> None:
    COUNTERS.record_fault(kind, n)


def record_gather_skip() -> None:
    COUNTERS.record_gather_skip()


# the sparse round ledger too: a fallback is evidence the capacity estimate
# broke, and a round is one host round trip, never a hot inner loop
def record_sparse_round(rows: int) -> None:
    COUNTERS.record_sparse_round(rows)


def record_sparse_fallback() -> None:
    COUNTERS.record_sparse_fallback()


def record_sparse_skip() -> None:
    COUNTERS.record_sparse_skip()


# collectives are telemetry: one call and a falsy check when counting is off
def record_collective(kind: str, value: Any, crossing: str = "world", fanout: Optional[int] = None) -> None:
    if COUNTERS.enabled:
        COUNTERS.record_collective(kind, value, crossing=crossing, fanout=fanout)


def record_states_synced(n: int) -> None:
    if COUNTERS.enabled:
        COUNTERS.record_states_synced(n)


# the gauges are telemetry and share the enabled gate
def record_slab_slots(label: str, slots: int, occupied: int, evictions: int) -> None:
    if COUNTERS.enabled:
        COUNTERS.record_slab_slots(label, slots, occupied, evictions)


def record_heavy_hitters(label: str, hot_slots: int, hot_occupied: int, promotions: int, demotions: int,
                         tail_mass: int, tail_bound: float) -> None:
    if COUNTERS.enabled:
        COUNTERS.record_heavy_hitters(label, hot_slots, hot_occupied, promotions, demotions, tail_mass, tail_bound)


def record_wm_exchange(n: int = 1) -> None:
    if COUNTERS.enabled:
        COUNTERS.record_wm_exchange(n)


def record_watermark_agreement(label: str, agreed: Any, ranks: int, excluded: Any, exchanges: int) -> None:
    if COUNTERS.enabled:
        COUNTERS.record_watermark_agreement(label, agreed, ranks, excluded, exchanges)


# the deferred lifecycle is high-volume on a deferring loop (a dispatch and a
# fence a step): telemetry, gated like the gauges
def record_deferred(kind: str, n: int = 1) -> None:
    if COUNTERS.enabled:
        COUNTERS.record_deferred(kind, n)


def record_deferred_depth(label: str, current: int) -> None:
    if COUNTERS.enabled:
        COUNTERS.record_deferred_depth(label, current)


def record_cache(which: str, hit: bool) -> None:
    if COUNTERS.enabled:
        COUNTERS.record_cache(which, hit)


# service health records unconditionally, as in the JAX package: a gauge
# write is one dict store, and health must not vanish because counting is off
def record_service_health(label: str, state: str, shed_events: int = 0, published: int = 0,
                          queue_depth: int = 0) -> None:
    COUNTERS.record_service_health(label, state, shed_events, published, queue_depth)


def record_state_bytes(metric: str, nbytes: int) -> None:
    if COUNTERS.enabled:
        COUNTERS.record_state_bytes(metric, nbytes)


def record_fleet_shards(label: str, shards: Dict[Any, Dict[str, Any]]) -> None:
    if COUNTERS.enabled:
        COUNTERS.record_fleet_shards(label, shards)


# the health plane's gauges (observability/lifecycle.py) share the enabled gate
def record_lifecycle(label: str, windows_stamped: int, open_windows: int, e2e_ms: float) -> None:
    if COUNTERS.enabled:
        COUNTERS.record_lifecycle(label, windows_stamped, open_windows, e2e_ms)


def record_watermark_lag(label: str, lag_s: float, degraded: bool) -> None:
    if COUNTERS.enabled:
        COUNTERS.record_watermark_lag(label, lag_s, degraded)


def record_publish_stamp(label: str, ns: int) -> None:
    if COUNTERS.enabled:
        COUNTERS.record_publish_stamp(label, ns)


def record_selfmeter(label: str, stage: str, summary: Dict[str, float]) -> None:
    if COUNTERS.enabled:
        COUNTERS.record_selfmeter(label, stage, summary)


def record_retention(label: str, windows_banked: int, rollups: int, resident_bytes: int, queries: int) -> None:
    if COUNTERS.enabled:
        COUNTERS.record_retention(label, windows_banked, rollups, resident_bytes, queries)


def state_nbytes(state: Any) -> int:
    """Byte footprint of one state (a dict, list, tuple, buffer or sketch of
    tensors): ``numel * element_size`` of every tensor in it, read from the
    tensors' metadata (no device work). A buffer counts its data and count, a
    sketch its counts, a list state each element; host numpy arrays (banked
    partials) count as the JAX package counts its array leaves."""
    if isinstance(state, torch.Tensor):
        return int(state.numel()) * int(state.element_size())
    if isinstance(state, (np.ndarray, np.generic)):
        return int(state.size) * int(state.dtype.itemsize)
    if isinstance(state, dict):
        return sum(state_nbytes(v) for v in state.values())
    if isinstance(state, (list, tuple)):  # NamedTuples (buffers, sketches) included
        return sum(state_nbytes(v) for v in state)
    return 0


def enable() -> None:
    COUNTERS.enabled = True


def disable() -> None:
    COUNTERS.enabled = False


def is_enabled() -> bool:
    return COUNTERS.enabled


def reset() -> None:
    COUNTERS.reset()


def snapshot(reset_after: bool = False) -> Dict[str, Any]:
    out = COUNTERS.snapshot()
    if reset_after:
        COUNTERS.reset()
    return out
