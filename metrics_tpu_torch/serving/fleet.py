"""MetricFleet: N hash-partitioned ingest shards and one merge tier.

Counterpart of ``metrics_tpu/serving/fleet.py``, with the same routing,
merge rule, records and failover:

- **Hash-partitioned ingest shards.** ``submit(key, *data, event_time=)``
  routes a tenant's batch to shard ``stable_key_hash(key) % N``, the 64-bit
  FNV-1a of ``parallel/cms.py`` (identical across processes, restarts and the
  two packages). Each shard is a full
  :class:`~metrics_tpu_torch.serving.service.MetricService` over its own
  ``Windowed`` state from the fleet's ``metric_factory``, with its own queue
  and backpressure.
- **The merge tier.** Each shard's publish stage hands the fleet its closed
  window's raw partial (the ``partial_publish_fn`` tap); once every shard has
  closed window ``w`` the fleet emits one merged record for ``w``, exactly
  once and in window order, by pure state addition
  (:meth:`~metrics_tpu_torch.wrappers.windowed.Windowed.value_from_partials`):
  equal to one process over all the traffic.
- **Shard failover.** :meth:`recover_shard` rebuilds a dead shard, restores a
  snapshot and replays the fleet's per-shard log by the original ``seq=``
  ids; folded steps no-op, so no window is lost or merged twice.

:class:`HeavyHitterFleet` routes open-world keys over ``HeavyHitters`` shards
whose hot sets are disjoint, so the global top-k is a merge and a sort.

The fleet is host supervision (threads, queues, numpy); the device work is
the shards' own window scatters and the merges' torch ops.
"""
import itertools
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.core.streaming import WatermarkAgreement
from metrics_tpu_torch.observability.counters import COUNTERS as _COUNTERS
from metrics_tpu_torch.observability.counters import record_fleet_shards
from metrics_tpu_torch.observability.lifecycle import LEDGER as _LEDGER
from metrics_tpu_torch.observability.selfmeter import SELFMETER, merge_meters
from metrics_tpu_torch.observability.trace import TRACE as _TRACE
from metrics_tpu_torch.observability.trace import span as _span
from metrics_tpu_torch.parallel.cms import stable_key_hash, stable_key_hash_array
from metrics_tpu_torch.parallel.slab import PARTIAL_SCHEMA_VERSION
from metrics_tpu_torch.parallel.sync import SyncGuard
from metrics_tpu_torch.serving.service import MetricService, ServiceStoppedError
from metrics_tpu_torch.utils.data import host_copy, host_tree
from metrics_tpu_torch.wrappers.heavy_hitters import HeavyHitters
from metrics_tpu_torch.wrappers.windowed import _ROWS_STATE, Windowed

__all__ = [
    "FLEET_SITE",
    "HeavyHitterFleet",
    "MetricFleet",
    "ShardStoppedError",
    "shard_for_key",
    "shards_for_keys",
    "stable_key_hash",
]

# the chaos-injector site fleet shards consult (FaultSpec(site=..., shard=i))
FLEET_SITE = "fleet.shard"


def shard_for_key(key: Any, num_shards: int) -> int:
    """``stable_key_hash(key) % num_shards``: the routing contract."""
    if not (isinstance(num_shards, int) and num_shards >= 1):
        raise ValueError(f"num_shards must be a positive int, got {num_shards!r}")
    return stable_key_hash(key) % num_shards


def shards_for_keys(keys: Any, num_shards: int) -> np.ndarray:
    """:func:`shard_for_key` over a whole key batch: one ``int64`` shard a
    key, from the one-pass array hash (bit-equal to the scalar one)."""
    if not (isinstance(num_shards, int) and num_shards >= 1):
        raise ValueError(f"num_shards must be a positive int, got {num_shards!r}")
    return (stable_key_hash_array(keys) % np.uint64(num_shards)).astype(np.int64)


class ShardStoppedError(ServiceStoppedError):
    """A fleet shard's worker is not accepting events. ``shard`` is its
    index: :meth:`MetricFleet.recover_shard` it; the failed submission is
    already in the replay log, so recovery delivers it (do not re-submit)."""

    def __init__(self, shard: int, message: str):
        super().__init__(message)
        self.shard = shard


class MetricFleet:
    """N hash-partitioned ``MetricService`` ingest shards and a merge tier.

    Args:
        metric_factory: zero-argument callable building one shard's
            ``Windowed`` ring (a fresh, identically configured instance a
            call; one extra instance is the merge tier's finisher).
        num_shards: N; routing is ``stable_key_hash(key) % N``.
        queue_size / shed_policy / guard / deferred_publish /
            poll_interval_s: every shard's ``MetricService`` configuration.
        merged_publish_fn: callback receiving each merged window record.
        name: the gauge label (shards are ``<name>/shard<i>``).
        replay_log: per-shard bound on the failover replay ring.
        agreement: ``True`` builds a
            :class:`~metrics_tpu_torch.core.streaming.WatermarkAgreement` over
            the shards (each joins as rank ``i``), or pass one; ``None`` keeps
            per-shard clocks. A straggler the agreement excludes does not hold
            the merge frontier; its windows merge stamped ``degraded=True``.
        merged_partial_publish_fn: callback receiving ``(record, merged
            partial)`` per merged window (the retention tier's tap).
    """

    _ids = itertools.count()

    def __init__(
        self,
        metric_factory: Callable[[], Windowed],
        num_shards: int,
        queue_size: int = 64,
        shed_policy: str = "block",
        guard: Optional[SyncGuard] = None,
        merged_publish_fn: Optional[Callable[[Dict[str, Any]], None]] = None,
        name: Optional[str] = None,
        replay_log: int = 512,
        deferred_publish: bool = True,
        poll_interval_s: float = 0.02,
        agreement: Union[None, bool, WatermarkAgreement] = None,
        merged_partial_publish_fn: Optional[
            Callable[[Dict[str, Any], Dict[str, Any]], None]
        ] = None,
    ):
        if not callable(metric_factory):
            raise ValueError("`metric_factory` must be a zero-arg callable building a Windowed metric")
        if not (isinstance(num_shards, int) and num_shards >= 1):
            raise ValueError(f"`num_shards` must be a positive int, got {num_shards!r}")
        if not (isinstance(replay_log, int) and replay_log >= 1):
            raise ValueError(f"`replay_log` must be a positive int, got {replay_log!r}")
        template = metric_factory()
        if not isinstance(template, Windowed) or template.decay:
            raise ValueError(
                "`metric_factory` must build Windowed ring metrics (the fleet"
                " merges per-window partials; the decay accumulator has none)"
            )
        self._factory = metric_factory
        self._template = template  # the merge tier's finisher (never updated)
        self.num_shards = num_shards
        self.num_windows = template.num_windows
        self.window_s = template.window_s
        self.label = name or f"MetricFleet({type(template.metric).__name__})#{next(MetricFleet._ids)}"
        self._shard_kw = dict(
            queue_size=queue_size, shed_policy=shed_policy, guard=guard,
            deferred_publish=deferred_publish, poll_interval_s=poll_interval_s,
        )
        if agreement is True:
            deadline = guard.deadline_s if guard is not None and guard.deadline_s else 30.0
            agreement = WatermarkAgreement(
                deadline_s=deadline, policy="degrade", label=f"{self.label}/wm"
            )
        elif not (agreement is None or isinstance(agreement, WatermarkAgreement)):
            raise ValueError(
                "`agreement` must be None, True, or a WatermarkAgreement,"
                f" got {agreement!r}"
            )
        self.agreement: Optional[WatermarkAgreement] = agreement or None

        self._lock = threading.RLock()
        self.merged_publish_fn = merged_publish_fn
        # read at emit time, so RetentionStore.attach after construction works
        self.merged_partial_publish_fn = merged_partial_publish_fn
        self.merged_records: List[Dict[str, Any]] = []
        self._partials: Dict[int, Dict[int, Dict[str, Any]]] = {}  # window -> shard -> partial
        self._pub_degraded: Dict[int, bool] = {}  # window -> any contributing shard degraded
        self._flows: Dict[int, List[int]] = {}  # window -> contributing shard flow ids
        self._last_merge_ns: Optional[int] = None  # perf_counter_ns of the last merged emit
        self._closed_through: List[Optional[int]] = [None] * num_shards
        self._merged_through: Optional[int] = None
        self._seqs = [0] * num_shards  # next auto-assigned per-shard seq
        self._replay: List[deque] = [deque(maxlen=replay_log) for _ in range(num_shards)]
        self._recoveries = 0
        self._shards: List[MetricService] = [self._build_shard(i) for i in range(num_shards)]

    def _build_shard(self, index: int) -> MetricService:
        metric = self._factory()
        if self.agreement is not None:
            # a recovered shard re-attaches under the same rank; its restored
            # report is monotone, so replay cannot regress the agreed min
            metric.attach_agreement(self.agreement, rank=index)
        return MetricService(
            metric,
            name=f"{self.label}/shard{index}",
            partial_publish_fn=(
                lambda record, partial, _shard=index: self._on_shard_publish(_shard, record, partial)
            ),
            fault_site=FLEET_SITE,
            fault_shard=index,
            **self._shard_kw,
        )

    # ------------------------------------------------------------- routing
    @property
    def shards(self) -> tuple:
        """The live per-shard services (replaced on :meth:`recover_shard`)."""
        return tuple(self._shards)

    def shard_of(self, key: Any) -> int:
        """Where ``key``'s traffic routes."""
        return shard_for_key(key, self.num_shards)

    def submit(
        self, key: Any, *args: Any, event_time: Any = None,
        seq: Optional[int] = None, **kwargs: Any,
    ) -> tuple:
        """Route one tenant-keyed batch to its shard; returns ``(shard, seq)``.

        The submission enters the shard's replay ring before its queue, so a
        batch in flight at a shard kill is replayable. A dead shard raises
        :class:`ShardStoppedError`; recover it and do not re-submit.
        """
        shard = shard_for_key(key, self.num_shards)
        with self._lock:
            if seq is None:
                seq = self._seqs[shard]
            self._seqs[shard] = max(self._seqs[shard], seq + 1)
            self._replay[shard].append((seq, args, event_time, kwargs))
            service = self._shards[shard]
        try:
            service.submit(*args, event_time=event_time, seq=seq, **kwargs)
        except ServiceStoppedError as err:
            raise ShardStoppedError(
                shard,
                f"fleet shard {shard} is {service.state}; recover_shard({shard})"
                " replays this submission from the log — do not re-submit it",
            ) from err
        return shard, seq

    # ---------------------------------------------------------- merge tier
    def _on_shard_publish(self, shard: int, record: Dict[str, Any], partial: Dict[str, Any]) -> None:
        """The per-shard publish tap: bank the partial, advance the shard's
        closed-through window, emit every window all shards have closed."""
        window = int(record["window"])
        with self._lock:
            self._partials.setdefault(window, {})[shard] = partial
            fid = record.get("flow")
            if fid is not None:
                self._flows.setdefault(window, []).append(int(fid))
            self._pub_degraded[window] = self._pub_degraded.get(window, False) or bool(
                record["degraded"]
            )
            current = self._closed_through[shard]
            self._closed_through[shard] = window if current is None else max(current, window)
            self._emit_ready_locked()
        self._note_gauges()

    def _emit_ready_locked(self, force: bool = False) -> None:
        """Emit merged records in window order, exactly once, up to the
        fleet's min closed-through window over the shards the agreement does
        not exclude (a shard that published past ``w`` without ``w`` had no
        samples there). ``force`` (finalize) emits through the highest window
        any shard published."""
        if not self._partials:
            return
        excluded = self._excluded_shards()
        if force:
            frontier = max(self._partials)
        else:
            closed = [
                c for i, c in enumerate(self._closed_through) if i not in excluded
            ]
            if not closed or any(c is None for c in closed):
                return  # a participating shard has yet to close its first window
            frontier = min(closed)
        for window in sorted(self._partials):
            if self._merged_through is not None and window <= self._merged_through:
                continue
            if window > frontier:
                break
            all_closed = all(
                c is not None and c >= window for c in self._closed_through
            )
            self._emit_locked(
                window, forced=not all_closed,
                degraded=bool(excluded) and not all_closed,
            )

    def _excluded_shards(self) -> frozenset:
        """Shard indices the fleet agreement currently excludes (reading
        ``agreed()`` first runs the straggler scan)."""
        if self.agreement is None:
            return frozenset()
        self.agreement.agreed()
        return frozenset(
            r for r in self.agreement.excluded() if isinstance(r, int)
        )

    def _emit_locked(self, window: int, forced: bool, degraded: bool = False) -> None:
        partials = self._partials.get(window, {})
        flows = sorted(set(self._flows.pop(window, [])))
        attrs = None
        if _TRACE.enabled:
            attrs = {"fleet": self.label, "window": window}
            if flows:
                attrs["flow"] = flows
        with _span("fleet.merge", attrs):
            value = self._template.value_from_partials(list(partials.values()))
            rows = sum(float(np.asarray(p["rows"])) for p in partials.values())
            # a merged window is only as complete as its least complete partial
            final = not forced and all(
                bool(p.get("final", True)) for p in partials.values()
            )
            record = {
                "fleet": self.label,
                "window": window,
                "window_start_s": self._template.window_start(window),
                "value": np.asarray(host_tree(value)),
                "rows": rows,
                "shards": sorted(partials),
                "degraded": degraded or self._pub_degraded.get(window, False),
                "forced": forced,
                "final": final,
                "flow": flows,
            }
            self.merged_records.append(record)
            self._merged_through = window
            self._last_merge_ns = time.perf_counter_ns()
            if _LEDGER.enabled:
                for shard in record["shards"]:
                    _LEDGER.stamp(
                        f"{self.label}/shard{shard}", window, "merged",
                        ns=self._last_merge_ns,
                    )
                _LEDGER.stamp(self.label, window, "merged", ns=self._last_merge_ns)
            if self.merged_partial_publish_fn is not None:
                self.merged_partial_publish_fn(
                    record, self._merged_partial(window, list(partials.values()), final)
                )
            # partials older than the ring can never be resident again
            for old in [w for w in self._partials if w <= window - self.num_windows]:
                self._partials.pop(old, None)
                self._pub_degraded.pop(old, None)
                self._flows.pop(old, None)
            if self.merged_publish_fn is not None:
                self.merged_publish_fn(record)

    def _merged_partial(
        self, window: int, partials: List[Dict[str, Any]], final: bool
    ) -> Dict[str, Any]:
        """The window's shard partials merged into one bankable partial."""
        inner, rows = self._template.merge_partials(partials)
        return {
            "version": PARTIAL_SCHEMA_VERSION,
            "window": int(window),
            "window_start_s": self._template.window_start(window),
            "rows": host_copy(rows),
            "state": host_tree(inner),
            "final": bool(final),
        }

    def merged_compute(self) -> Any:
        """The global sliding view: every globally resident window's
        partials, across all shards, merged and finished once."""
        with self._lock:
            heads = [s.metric.head_window for s in self._shards if s.metric.head_window is not None]
            if not heads:
                return self._template.value_from_partials([])
            head = max(heads)
            partials = [
                p
                for window, by_shard in self._partials.items()
                if window > head - self.num_windows
                for p in by_shard.values()
            ]
            return self._template.value_from_partials(partials)

    # ------------------------------------------------------------ failover
    def recover_shard(self, shard: int, snapshot: Optional[Dict[str, Any]] = None,
                      timeout_s: float = 30.0) -> MetricService:
        """Rebuild a dead (or sick) shard: restore ``snapshot`` (default a
        fresh snapshot of the dead shard), then replay the shard's log with
        the original seq ids; folded steps no-op. Returns the replacement."""
        if not (0 <= shard < self.num_shards):
            raise ValueError(f"shard must be in [0, {self.num_shards}), got {shard}")
        with self._lock:
            dead = self._shards[shard]
        dead.stop(timeout_s)
        snap = snapshot if snapshot is not None else dead.snapshot()
        replacement = self._build_shard(shard)
        if snap is not None:
            replacement.restore(snap)
        with self._lock:
            self._shards[shard] = replacement
            self._recoveries += 1
            log = list(self._replay[shard])
        for seq, args, event_time, kwargs in log:
            replacement.submit(*args, event_time=event_time, seq=seq, **kwargs)
        replacement.flush(timeout_s)
        self._note_gauges()
        return replacement

    # ----------------------------------------------------------- lifecycle
    def flush(self, timeout_s: float = 30.0) -> None:
        """Barrier: every shard drained and its publishes landed. A dead
        shard raises its stored error."""
        deadline = time.monotonic() + timeout_s
        for service in list(self._shards):
            service.flush(max(deadline - time.monotonic(), 0.001))

    def finalize(self, timeout_s: float = 30.0) -> Any:
        """Drain every shard, then finalize each, emit the remaining merged
        windows (``forced=True`` where a lagging shard never closed them) and
        return the global merged view."""
        deadline = time.monotonic() + timeout_s
        # drain all before any finalizes: each shard's final watermark is
        # then reported to the agreement before a shard waits on it
        self.flush(timeout_s)
        for service in list(self._shards):
            service.finalize(max(deadline - time.monotonic(), 0.001))
        with self._lock:
            self._emit_ready_locked(force=True)
        self._note_gauges()
        return self.merged_compute()

    def stop(self, timeout_s: float = 30.0) -> None:
        """Stop every shard (idempotent, best effort on dead shards)."""
        deadline = time.monotonic() + timeout_s
        for service in list(self._shards):
            service.stop(max(deadline - time.monotonic(), 0.001))

    def __enter__(self) -> "MetricFleet":
        return self

    def __exit__(self, *exc: Any) -> bool:
        self.stop()
        return False

    # --------------------------------------------------------------- health
    def health_report(self) -> Dict[str, Any]:
        """One fleet-wide view: every shard's self-meter sketches folded per
        stage (``merge_meters``), each shard's health and last-publish verdict,
        the merge frontier and ``staleness_s`` since the last merged emit
        (``nan`` before it). Meters fill only while the ledger is enabled."""
        with self._lock:
            services = list(self._shards)
            merged_through = self._merged_through
            last_merge_ns = self._last_merge_ns
        shard_meters = [SELFMETER.meters(s.label) for s in services]
        stages = sorted({stage for meters in shard_meters for stage in meters})
        latency: Dict[str, Dict[str, float]] = {}
        for stage in stages:
            fold = merge_meters(m[stage] for m in shard_meters if stage in m)
            if fold is not None:
                latency[stage] = fold.summary()
        shards: Dict[str, Dict[str, Any]] = {}
        degraded: List[int] = []
        for index, service in enumerate(services):
            last_degraded = bool(service._last_publish_degraded)
            shards[str(index)] = {
                "health": service.health,
                "published": len(service.publications),
                "degraded": last_degraded,
            }
            if last_degraded or service.health in ("degraded", "dead"):
                degraded.append(index)
        staleness_s = (
            (time.perf_counter_ns() - last_merge_ns) / 1e9
            if last_merge_ns is not None else float("nan")
        )
        return {
            "fleet": self.label,
            "shards": shards,
            "degraded_shards": degraded,
            "merged_through": merged_through,
            "latency": latency,
            "staleness_s": staleness_s,
        }

    # --------------------------------------------------------------- gauges
    def _note_gauges(self) -> None:
        """Refresh the ``fleet_shards`` gauge (health, queue depth, occupied
        window slots, published windows, replayed steps); enabled-gated, since
        the occupancy read is a readback."""
        if not _COUNTERS.enabled:
            return
        shards: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            services = list(self._shards)
        for index, service in enumerate(services):
            rows = service.metric._current_state()[_ROWS_STATE]
            shards[str(index)] = {
                "health": service.health,
                "queue_depth": service._queue.qsize(),
                "occupied": int((rows > 0).sum()),
                "published": len(service.publications),
                "replayed": service.replayed_steps,
            }
        record_fleet_shards(self.label, shards)

    def __repr__(self) -> str:
        return (
            f"MetricFleet({type(self._template.metric).__name__},"
            f" num_shards={self.num_shards}, merged={len(self.merged_records)})"
        )


class HeavyHitterFleet:
    """N hash-partitioned ``HeavyHitters`` shards: open-world multi-tenant
    serving with no pre-sized key space. Each key lives on one shard (the
    stable router), so shard hot sets are disjoint and the global top-k is a
    merge and a sort of the shards' records.

    Args:
        metric_factory: zero-argument callable building one shard's
            ``HeavyHitters``.
        num_shards: N.

    Synchronous by design: the threaded ingest lives in
    ``MetricService`` / ``MetricFleet``.
    """

    def __init__(self, metric_factory: Callable[[], HeavyHitters], num_shards: int):
        if not callable(metric_factory):
            raise ValueError(
                "`metric_factory` must be a zero-arg callable building a HeavyHitters"
            )
        if not (isinstance(num_shards, int) and num_shards >= 1):
            raise ValueError(f"`num_shards` must be a positive int, got {num_shards!r}")
        self.num_shards = num_shards
        self.shards: List[HeavyHitters] = []
        for _ in range(num_shards):
            shard = metric_factory()
            if not isinstance(shard, HeavyHitters):
                raise ValueError(
                    "`metric_factory` must build HeavyHitters instances,"
                    f" got {type(shard).__name__}"
                )
            self.shards.append(shard)

    def shard_of(self, key: Any) -> int:
        """Where ``key``'s traffic routes."""
        return shard_for_key(key, self.num_shards)

    def submit(self, keys, *args: Any, **kwargs: Any) -> None:
        """Partition one keyed batch across the shards (one vectorized hash,
        one stable argsort) and update each non-empty shard once, in
        ascending shard order with its rows in submission order."""
        keys = list(keys)
        if not keys:
            return
        shards = shards_for_keys(keys, self.num_shards)
        order = np.argsort(shards, kind="stable")
        split_at = np.nonzero(np.diff(shards[order]))[0] + 1
        for rows in np.split(order, split_at):
            self.shards[int(shards[rows[0]])].update(
                *(_take(a, rows) for a in args),
                key=[keys[int(i)] for i in rows],
                **{k: _take(v, rows) for k, v in kwargs.items()},
            )

    def compute(self, key: Any) -> Any:
        """One key's value from its home shard."""
        return self.shards[self.shard_of(key)].compute(key=key)

    def compute_heavy_hitters(self, k: Optional[int] = None) -> List[Dict[str, Any]]:
        """The global top-k, heaviest first, each record with its ``shard``."""
        records: List[Dict[str, Any]] = []
        for index, shard in enumerate(self.shards):
            for record in shard.compute_heavy_hitters():
                records.append({**record, "shard": index})
        records.sort(key=lambda r: (-r["count"], str(r["key"])))
        return records[:k] if k is not None else records

    def tail_mass(self) -> int:
        """Total tail-resident samples across the fleet."""
        return sum(shard.tail_mass() for shard in self.shards)

    def tail_overcount_bound(self) -> float:
        """The fleet's certificate: the worst shard's ``(e / width) * N``."""
        return max(shard.tail_overcount_bound() for shard in self.shards)

    def __repr__(self) -> str:
        return f"HeavyHitterFleet(num_shards={self.num_shards})"


def _take(value: Any, rows: np.ndarray) -> Any:
    """The rows ``rows`` of one batch argument (a tensor on its own device)."""
    if isinstance(value, Tensor):
        return value.index_select(0, torch.from_numpy(rows.astype(np.int64)).to(value.device))
    return np.asarray(value)[rows.astype(np.int32)]
