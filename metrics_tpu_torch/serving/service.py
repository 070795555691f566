"""MetricService: the supervised serving loop over the window plane.

Counterpart of ``metrics_tpu/serving/service.py``, with the same loop, names,
records and snapshot layout:

- **Bounded ingress + shed policy.** ``submit()`` feeds a bounded queue that a
  background worker drains. With the queue full, ``shed_policy="block"`` holds
  the producer back and ``"drop_oldest"`` sheds the oldest queued batch and
  counts it (``shed_events``; the health gauge reads ``shedding``).
- **Queue-drain coalescing.** After the blocking ``get`` the worker takes up
  to ``coalesce_max_batches`` / ``coalesce_max_samples`` more queued batches
  and applies contiguous compatible ones as one routed update. Spans split
  wherever sequential semantics could diverge (a window-close boundary, a
  fault-addressed submission, a replayed seq, an attached agreement, a
  structure change), and each event is judged against its own batch's
  running-max watermark (``judge_prefix``), so every record, drop and replay
  count equals one-batch-at-a-time processing. Host arrays concatenate on the
  host, tensors with ``torch.cat`` on their device.
- **Watermark-aware windowing, degrade over stall.** The worker drives
  :class:`~metrics_tpu_torch.wrappers.windowed.Windowed`; as the watermark
  closes a window the service publishes it. The merged view syncs under the
  service's :class:`~metrics_tpu_torch.parallel.sync.SyncGuard`; a sync that
  exhausts its budget degrades to the local state and publishes
  ``degraded=True``.
- **Deferred publish stage** (default). The worker takes the close-point
  ``state_dict`` (host copies, so later ingest cannot reach them) and hands the
  guarded sync and the record build to the single-worker host plane
  (``parallel/deferred.py``), which loads it into a ``deepcopy`` shadow twin;
  records land in window order. ``flush`` / ``snapshot`` / ``finalize`` /
  ``stop`` drain the pipeline, and the records equal the synchronous stage's.
- **Crash-safe snapshot / restore.** Every publish refreshes
  :attr:`last_snapshot`; a fresh service ``restore()``\\ s it and the stream is
  replayed by the original ``seq=`` ids through ``guarded_update``, so steps
  already folded are no-ops.
- **Chaos.** The installed
  :class:`~metrics_tpu_torch.parallel.faults.ChaosInjector` is consulted on
  every ingest call at site ``service.ingest`` (``ingest_stall``,
  ``clock_skew``, ``late_burst``, ``preempt``).

On the card: the worker thread and the publish task run under
``torch.cuda.device(metric.device)`` (the current device is per thread). All of
a service's collectives come from one thread, the host-plane worker when the
publish is deferred and the service worker when it is not; ``finalize`` syncs
on the caller's thread after draining both. The ingest path itself issues no
collective (``guarded_update`` is an ``update``).
"""
import contextlib
import itertools
import math
import queue
import threading
import time
from copy import deepcopy
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.observability.counters import COUNTERS as _COUNTERS
from metrics_tpu_torch.observability.counters import (
    record_deferred_depth,
    record_service_health,
    record_watermark_lag,
)
from metrics_tpu_torch.observability.lifecycle import LEDGER as _LEDGER
from metrics_tpu_torch.observability.lifecycle import next_flow_id
from metrics_tpu_torch.observability.trace import TRACE as _TRACE
from metrics_tpu_torch.observability.trace import span as _span
from metrics_tpu_torch.parallel import faults as _faults
from metrics_tpu_torch.parallel.deferred import host_plane_submit
from metrics_tpu_torch.parallel.sync import SyncGuard, set_sync_guard
from metrics_tpu_torch.utils.data import host_tree
from metrics_tpu_torch.utils.exceptions import MetricsTorchError, PreemptionError
from metrics_tpu_torch.wrappers.windowed import Windowed

__all__ = ["HEALTH_STATES", "MetricService", "ServiceStoppedError"]

HEALTH_STATES = ("healthy", "degraded", "shedding")

_SHED_POLICIES = ("block", "drop_oldest")

# the injector site the ingest path consults (FaultSpec(site=...))
INGEST_SITE = "service.ingest"


class ServiceStoppedError(MetricsTorchError, RuntimeError):
    """The service's worker is not accepting events (stopped, preempted, or
    failed). ``MetricService.error`` holds the cause when there is one."""


def _device_scope(device: torch.device) -> Any:
    """``torch.cuda.device(device)`` for a card, else a null context: the
    current CUDA device is per thread, so a worker thread enters its metric's."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class MetricService:
    """Supervised update -> window-roll -> guarded-sync -> publish loop.

    Args:
        metric: the :class:`Windowed` ring the loop drives (wrap a
            :class:`~metrics_tpu_torch.wrappers.keyed.Keyed` inside for
            per-cohort windows).
        queue_size: ingress queue bound (batches, not samples).
        shed_policy: ``"block"`` (producer backpressure) or ``"drop_oldest"``.
        guard: the :class:`SyncGuard` every publish-time sync runs under.
            Default: degrade after a 5 s deadline and two retries.
        publish_fn: callback receiving each publication record.
        partial_publish_fn: callback receiving ``(record, partial)`` per
            publish, ``partial`` the closed window's mergeable state
            (:meth:`Windowed.window_partial` at the close point); the fleet's
            and the retention store's tap. Computed only when set.
        name: gauge and span label (``label=`` is an alias); unnamed services
            get ``MetricService(<inner>)#<k>``.
        deferred_publish: run the guarded sync of every publish on the host
            plane (default) or on the worker (``False``).
        coalesce_max_batches / coalesce_max_samples: queue-drain coalescing
            bounds (``coalesce_max_batches=1`` disables coalescing).
        fault_site / fault_shard / fault_rank: the chaos site, shard and rank
            this service's ingest path reports.

    The worker starts at once; use as a context manager or call :meth:`stop`.
    """

    _ids = itertools.count()  # the auto-indexed default-label sequence

    def __init__(
        self,
        metric: Windowed,
        queue_size: int = 1024,
        shed_policy: str = "block",
        guard: Optional[SyncGuard] = None,
        publish_fn: Optional[Callable[[Dict[str, Any]], None]] = None,
        partial_publish_fn: Optional[Callable[[Dict[str, Any], Dict[str, Any]], None]] = None,
        label: Optional[str] = None,
        name: Optional[str] = None,
        poll_interval_s: float = 0.02,
        deferred_publish: bool = True,
        coalesce_max_batches: int = 8,
        coalesce_max_samples: int = 8192,
        fault_site: str = INGEST_SITE,
        fault_shard: Optional[int] = None,
        fault_rank: Optional[int] = None,
    ):
        if not isinstance(metric, Windowed):
            raise ValueError(
                f"`metric` must be a Windowed metric (the service's loop is the"
                f" window plane's supervisor), got {type(metric).__name__}"
            )
        if metric.decay:
            raise ValueError(
                "the decay accumulator has no window roll to supervise; give the"
                " service a windowed ring (Windowed(..., window_s=))"
            )
        if shed_policy not in _SHED_POLICIES:
            raise ValueError(f"`shed_policy` must be one of {_SHED_POLICIES}, got {shed_policy!r}")
        if not (isinstance(queue_size, int) and queue_size >= 1):
            raise ValueError(f"`queue_size` must be a positive int, got {queue_size!r}")
        self.metric = metric
        self.shed_policy = shed_policy
        self.guard = guard if guard is not None else SyncGuard(
            deadline_s=5.0, max_retries=2, backoff_s=0.05, policy="degrade"
        )
        if self.guard.policy not in ("raise", "degrade"):
            raise ValueError(f"guard.policy must be 'raise' or 'degrade', got {self.guard.policy!r}")
        self.publish_fn = publish_fn
        self.partial_publish_fn = partial_publish_fn
        self.label = name or label or (
            f"MetricService({type(metric.metric).__name__})#{next(MetricService._ids)}"
        )
        # the window plane stamps its lifecycle ledger under this label; the
        # shadow twin inherits it but never routes events
        metric.lifecycle_label = self.label
        self.fault_site = str(fault_site)
        self.fault_shard = fault_shard
        self.fault_rank = fault_rank
        self._wm_force_degraded = False  # finalize timed out waiting for agreement
        self.poll_interval_s = float(poll_interval_s)
        self.deferred_publish = bool(deferred_publish)
        if not (isinstance(coalesce_max_batches, int) and coalesce_max_batches >= 1):
            raise ValueError(
                f"`coalesce_max_batches` must be a positive int, got {coalesce_max_batches!r}"
            )
        if not (isinstance(coalesce_max_samples, int) and coalesce_max_samples >= 1):
            raise ValueError(
                f"`coalesce_max_samples` must be a positive int, got {coalesce_max_samples!r}"
            )
        self.coalesce_max_batches = coalesce_max_batches
        self.coalesce_max_samples = coalesce_max_samples
        self.drains = 0  # worker drain cycles (>= 1 batch each)
        self.coalesced_batches = 0  # batches applied as part of a multi-batch span
        # the deferred stage's double buffer: a twin loaded from each
        # publish's close-point snapshot, so the background sync never races
        # the live metric's ingest
        self._shadow: Optional[Windowed] = None
        self._pub_lock = threading.RLock()  # publications / last_snapshot / health latches
        self._pending_publishes: List[Any] = []  # futures of in-flight deferred publishes

        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self._seq = 0  # next auto-assigned submission seq
        self._processed = 0  # items fully applied (or idempotently skipped)
        self._ingest_idx = 0  # fault-addressable ingest call counter
        self._published_through: Optional[int] = None  # highest window published
        self.publications: List[Dict[str, Any]] = []
        self.shed_events = 0
        self._replayed = 0  # guarded_update no-ops (idempotent replay skips)
        self._shed_since_publish = 0
        self._last_publish_degraded = False
        self.last_snapshot: Optional[Dict[str, Any]] = None
        self._error: Optional[BaseException] = None

        self._proc_lock = threading.RLock()  # one item / one snapshot at a time
        self._submit_lock = threading.Lock()  # seq assignment + shed atomicity
        self._stop = threading.Event()
        self._state = "running"
        self._worker = self._start_worker()
        self._note_health()

    def _start_worker(self) -> threading.Thread:
        worker = threading.Thread(target=self._run, daemon=True, name=f"mtpu-service-{id(self):x}")
        worker.start()
        return worker

    # ------------------------------------------------------------- ingress
    @property
    def state(self) -> str:
        """``running`` / ``stopped`` / ``preempted`` / ``failed``."""
        return self._state

    @property
    def error(self) -> Optional[BaseException]:
        """What killed the worker, when ``state`` is preempted / failed."""
        return self._error

    @property
    def health(self) -> str:
        """``healthy`` / ``degraded`` / ``shedding`` (the gauge value)."""
        if self._shed_since_publish:
            return "shedding"
        if self._last_publish_degraded:
            return "degraded"
        return "healthy"

    @property
    def processed(self) -> int:
        """Batches fully applied (or idempotently skipped on replay)."""
        return self._processed

    @property
    def replayed_steps(self) -> int:
        """Batches the epoch watermark skipped as already-folded replays."""
        return self._replayed

    def submit(self, *args: Any, event_time: Any = None, seq: Optional[int] = None,
               **kwargs: Any) -> int:
        """Enqueue one batch; returns its replay sequence id.

        ``event_time`` is forwarded to ``Windowed.update`` (read to host
        float64 here). ``seq`` is the idempotent-replay id, auto-assigned in
        submission order; pass the original ids when replaying into a
        restored service. With the queue full, ``block`` waits and
        ``drop_oldest`` sheds the oldest queued batch first.
        """
        if event_time is None:
            raise ValueError("MetricService.submit requires `event_time=`")
        if self._state != "running":
            raise ServiceStoppedError(
                f"service is {self._state}; not accepting events"
                + (f" (cause: {self._error!r})" if self._error else "")
            )
        if isinstance(event_time, np.ndarray) and event_time.dtype == np.float64:
            times = event_time
        elif isinstance(event_time, Tensor):
            times = event_time.detach().cpu().numpy().astype(np.float64)
        else:
            times = np.asarray(event_time, dtype=np.float64)
        with self._submit_lock:
            if seq is None:
                seq = self._seq
            self._seq = max(self._seq, seq + 1)
            item = (seq, args, times, kwargs)
            if self.shed_policy == "block":
                # backpressure with a live-worker check: blocking forever on
                # a dead worker would hang the producer
                while True:
                    try:
                        self._queue.put(item, timeout=self.poll_interval_s)
                        break
                    except queue.Full:
                        if self._state != "running":
                            raise ServiceStoppedError(
                                f"service is {self._state} with a full queue;"
                                " event not accepted"
                            ) from None
            else:
                while True:
                    try:
                        self._queue.put_nowait(item)
                        break
                    except queue.Full:
                        try:
                            self._queue.get_nowait()
                            self._queue.task_done()
                        except queue.Empty:
                            continue
                        self.shed_events += 1
                        self._shed_since_publish += 1
                        self._note_health()
        return seq

    # ------------------------------------------------------------ the loop
    def _run(self) -> None:
        with _device_scope(self.metric.device):
            self._drain_loop()

    def _drain_loop(self) -> None:
        while True:
            try:
                item = self._queue.get(timeout=self.poll_interval_s)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            # after the blocking get lands the first batch, pull what else is
            # already queued (bounded). Items pulled but never applied because
            # an earlier one preempted the worker are part of the lost
            # in-flight window: the caller replays them by seq after restore()
            items = [item]
            n_samples = _item_samples(item)
            while (
                len(items) < self.coalesce_max_batches
                and n_samples < self.coalesce_max_samples
            ):
                try:
                    extra = self._queue.get_nowait()
                except queue.Empty:
                    break
                items.append(extra)
                n_samples += _item_samples(extra)
            try:
                with self._proc_lock:
                    self._process_drain(items)
            except PreemptionError as err:
                self._error = err
                self._state = "preempted"
                return
            except BaseException as err:  # noqa: BLE001 - the supervisor records, not hides
                self._error = err
                self._state = "failed"
                return
            finally:
                for _ in items:
                    self._queue.task_done()

    def _process_drain(self, items: List[tuple]) -> None:
        """Apply one drain's batches: coalesced spans where sequential
        semantics are preserved, the one-batch path everywhere else."""
        injector = _faults.current_injector()
        i = 0
        while i < len(items):
            span = None
            if self.coalesce_max_batches > 1 and self.metric.agreement is None:
                span = self._gather_span(items, i, injector)
            if span is None:
                self._process(*items[i])
                i += 1
            else:
                self._process_span(span)
                i += len(span)
        self.drains += 1
        self._note_health()

    def _gather_span(self, items: List[tuple], start: int, injector: Optional[Any]):
        """The longest coalescible span of ``items[start:]`` as entries
        ``(seq, data, times, kw_keys, batch_watermark)``, or ``None`` when no
        span of two or more batches forms. A batch joins only with a
        contiguous live seq, no fault addressed to it, the same data
        structure, and the same head and closed-through windows; the span must
        publish nothing (decided at its first batch)."""
        m = self.metric
        stride, lat, win = m.window_stride, m.allowed_lateness_s, m.window_s
        epoch = m.epoch_watermark
        wm = m.watermark
        entries: List[tuple] = []
        struct0 = head0 = closed0 = None
        last_seq = None
        total = 0
        for offset in range(start, len(items)):
            if len(entries) >= self.coalesce_max_batches:
                break
            seq, args, times, kwargs = items[offset]
            if seq < epoch or (last_seq is not None and seq != last_seq + 1):
                break
            idx = self._ingest_idx + (offset - start)
            if injector is not None and injector.ingest_addressed(
                self.fault_site, idx, shard=self.fault_shard, rank=self.fault_rank
            ):
                break
            prof = _span_profile(args, times, kwargs)
            if prof is None:
                break
            data, t, struct = prof
            if entries and total + t.size > self.coalesce_max_samples:
                break
            peak = float(t.max())
            new_wm = peak if wm is None else max(wm, peak)
            head = int(math.floor(new_wm / stride))
            closed = int(math.floor((new_wm - lat - win) / stride))
            if entries:
                if struct != struct0 or head != head0 or closed != closed0:
                    break
            else:
                # the publish-free check: the lowest window that could still
                # publish (the first unpublished resident window, the next to
                # open on an exhausted ring, or the lowest this batch opens)
                if m.head_window is None:
                    lo: Optional[int] = int(math.floor(float(t.min()) / stride))
                else:
                    lo = next(
                        (
                            w for w in m.resident_windows()
                            if self._published_through is None
                            or w > self._published_through
                        ),
                        m.head_window + 1,
                    )
                if self._published_through is not None:
                    lo = max(lo, self._published_through + 1)
                if lo < head - m.num_windows + 1 or lo <= closed:
                    return None  # this batch publishes: it fires alone
                struct0, head0, closed0 = struct, head, closed
            entries.append((seq, data, t, tuple(kwargs), new_wm))
            last_seq = seq
            wm = new_wm
            total += t.size
            epoch += 1
        return entries if len(entries) >= 2 else None

    def _process_span(self, entries: List[tuple]) -> None:
        """Apply one coalesced span as one routed update, judged with the
        per-event prefix running-max watermark; ``guarded_update`` folds the
        whole seq range so a replay of any part of it no-ops."""
        seq_a, seq_b = entries[0][0], entries[-1][0]
        self._ingest_idx += len(entries)
        kw_keys = entries[0][3]
        n_data = len(entries[0][1])
        n_args = n_data - len(kw_keys)
        cat = tuple(_concat([e[1][j] for e in entries]) for j in range(n_data))
        times = np.concatenate([e[2] for e in entries])
        judge = np.concatenate([np.full(e[2].shape, e[4]) for e in entries])
        self._publish_expiring(times)
        if self.metric.guarded_update(
            seq_a, *cat[:n_args], event_time=times, judge_prefix=judge,
            span_end=seq_b, **dict(zip(kw_keys, cat[n_args:])),
        ):
            self.coalesced_batches += len(entries)
        else:
            self._replayed += len(entries)
        self._processed += len(entries)
        self._publish_closed()

    def _process(self, seq: int, args: tuple, times: np.ndarray, kwargs: dict) -> None:
        injector = _faults.current_injector()
        idx = self._ingest_idx
        self._ingest_idx += 1
        if injector is not None:
            for spec in injector.ingest_faults(
                self.fault_site, idx, shard=self.fault_shard, rank=self.fault_rank
            ):
                if spec.kind == "ingest_stall":
                    time.sleep(spec.duration_s)
                elif spec.kind == "clock_skew":
                    times = times + spec.skew_s
                elif spec.kind == "late_burst":
                    times = times - spec.skew_s
                elif spec.kind == "preempt":
                    raise PreemptionError(
                        f"injected service preemption at ingest call {idx} (seq {seq})"
                    )
        self._publish_expiring(times)
        if not self.metric.guarded_update(seq, *args, event_time=times, **kwargs):
            self._replayed += 1
        self._processed += 1
        self._publish_closed()

    def _publish_expiring(self, times: np.ndarray) -> None:
        """Publish, before the batch applies, every resident window its
        watermark advance will expire from the ring. Such a window cannot
        receive an event of this batch (the lateness cap is ``(W - 1) *
        window_s``), so the pre-update publish is exact and a watermark jump
        loses no closed window."""
        wm = self.metric.watermark
        peak = float(times.max()) if times.size else None
        if peak is None:
            return
        new_wm = peak if wm is None else max(wm, peak)
        m = self.metric
        expire_below = int(math.floor(new_wm / m.window_stride)) - m.num_windows + 1
        for window in m.resident_windows():
            if window >= expire_below:
                break
            if self._published_through is not None and window <= self._published_through:
                continue
            self._publish(window, final=True)

    def _closed_through(self) -> Optional[int]:
        """Highest window no future event can reach, by the metric's close
        clock (the agreed watermark under an agreement, ``None`` until it
        forms; the local running max otherwise)."""
        wm = self.metric.close_watermark
        if wm is None:
            return None
        m = self.metric
        return int(math.floor((wm - m.allowed_lateness_s - m.window_s) / m.window_stride))

    def _publish_closed(self, force_through: Optional[int] = None) -> None:
        closed_by_clock = self._closed_through()
        closed = closed_by_clock if force_through is None else force_through
        if closed is None:
            return
        for window in self.metric.resident_windows():
            if window > closed:
                break
            if self._published_through is not None and window <= self._published_through:
                continue
            # final: the close clock passed the window (its contents are the
            # whole truth), not a finalize() flush of an open one
            final = closed_by_clock is not None and window <= closed_by_clock
            self._publish(window, final=final)

    def _publish(self, window: int, final: bool = True) -> None:
        """Publish one closed window: the guarded merged view and the window's
        own value, stamped ``degraded=`` and ``final=``, then refresh the
        crash snapshot. Deferred: the guarded sync runs on the host plane over
        the close-point ``state_dict`` and the record lands in window order."""
        self._published_through = window
        fid = None
        if _LEDGER.enabled:
            _LEDGER.stamp(self.label, window, "closed")
            fid = next_flow_id()
        book = self._publish_book()
        book["final"] = bool(final)
        book["flow"] = fid
        if not self.deferred_publish:
            self._publish_record(self.metric, window, book)
            return
        attrs = None
        if _TRACE.enabled:
            attrs = {"service": self.label, "window": window}
            if fid is not None:
                attrs["flow"] = fid
        with _span("service.publish_dispatch", attrs):
            snap = self.metric.state_dict()  # host copies: the double buffer
            if self._shadow is None:
                self._shadow = deepcopy(self.metric)
            with self._pub_lock:
                self._pending_publishes.append(
                    host_plane_submit(self._deferred_publish_task, snap, window, book)
                )
                depth = len(self._pending_publishes)
        record_deferred_depth(self.label, depth)

    def _publish_book(self) -> Dict[str, Any]:
        """Close-point bookkeeping, captured on the worker thread."""
        return {
            "watermark": self.metric.watermark,
            "agreed_watermark": getattr(self.metric, "agreed_watermark", None),
            "wm_degraded": self._wm_force_degraded or self.metric.agreement_degraded,
            "dropped_samples": self.metric.dropped_samples,
            "shed_events": self.shed_events,
            "queue_depth": self._queue.qsize(),
            "processed": self._processed,
            "ingest_idx": self._ingest_idx,
        }

    def _deferred_publish_task(self, snap: Dict[str, Any], window: int, book: Dict[str, Any]) -> None:
        with _device_scope(self._shadow.device):
            self._shadow.load_state_dict(snap)
            self._publish_record(self._shadow, window, book, snap=snap)

    def _publish_record(
        self, metric: Windowed, window: int, book: Dict[str, Any],
        snap: Optional[Dict[str, Any]] = None,
    ) -> None:
        """The publish body both stages share: guarded sync and record build,
        under one ``service.publish`` span a window."""
        fid = book.get("flow")
        attrs = None
        if _TRACE.enabled:
            attrs = {
                "service": self.label,
                "window": window,
                "queue_depth": book["queue_depth"],
                "deferred": "yes" if snap is not None else "no",
            }
            if fid is not None:
                attrs["flow"] = fid
        with _span("service.publish", attrs):
            if _LEDGER.enabled:
                _LEDGER.stamp(self.label, window, "sync_started")
            before = _COUNTERS.faults["degraded_computes"]
            old_guard = set_sync_guard(self.guard)
            try:
                metric._computed = None  # publish-time values, not a stale cache
                merged = metric.compute()
            finally:
                set_sync_guard(old_guard)
            if _LEDGER.enabled:
                _LEDGER.stamp(self.label, window, "sync_done")
            degraded = _COUNTERS.faults["degraded_computes"] > before or bool(
                book.get("wm_degraded")
            )
            value = metric.compute_window(window)
            partial = (
                metric.window_partial(window)
                if self.partial_publish_fn is not None else None
            )
            final = bool(book.get("final", True))
            if partial is not None:
                partial["final"] = final  # retention tells a truncated window from a complete one
            if attrs is not None:
                attrs["degraded"] = "yes" if degraded else "no"
            record = {
                "service": self.label,
                "window": window,
                "window_start_s": self.metric.window_start(window),
                "value": host_tree(value),
                "merged": host_tree(merged),
                "degraded": degraded,
                "final": final,
                "flow": fid,
                "watermark": book["watermark"],
                "agreed_watermark": book.get("agreed_watermark"),
                "dropped_samples": book["dropped_samples"],
                "shed_events": book["shed_events"],
            }
            with self._pub_lock:
                self.publications.append(record)
                self._last_publish_degraded = degraded
                self._shed_since_publish = 0
                self.last_snapshot = {
                    "metric": snap if snap is not None else self.metric.state_dict(),
                    "processed": book["processed"],
                    "ingest_idx": book["ingest_idx"],
                    "published_through": window,
                    "shed_events": book["shed_events"],
                    "publications": len(self.publications),
                }
            if _LEDGER.enabled:
                _LEDGER.stamp(self.label, window, "published")
                wm = book.get("agreed_watermark")
                if wm is None:
                    wm = book.get("watermark")
                if wm is not None:
                    record_watermark_lag(self.label, time.time() - float(wm), degraded)
                if attrs is not None:
                    e2e = _LEDGER.latencies(self.label, window).get("e2e")
                    if e2e is not None:
                        attrs["e2e_ms"] = e2e
            if self.publish_fn is not None:
                self.publish_fn(record)
            if self.partial_publish_fn is not None:
                self.partial_publish_fn(record, partial)
            self._note_health()

    def _drain_publishes(self, timeout_s: float) -> None:
        """Barrier over the deferred publish pipeline; a publish task that
        raised re-raises here."""
        deadline = time.monotonic() + timeout_s
        while True:
            with self._pub_lock:
                if not self._pending_publishes:
                    record_deferred_depth(self.label, 0)
                    return
                fut = self._pending_publishes[0]
            fut.result(max(deadline - time.monotonic(), 0.001))
            with self._pub_lock:
                if self._pending_publishes and self._pending_publishes[0] is fut:
                    self._pending_publishes.pop(0)
                record_deferred_depth(self.label, len(self._pending_publishes))

    def _note_health(self) -> None:
        record_service_health(
            self.label, self.health, self.shed_events, len(self.publications),
            self._queue.qsize(),
        )

    # ---------------------------------------------------------- lifecycle
    def flush(self, timeout_s: float = 30.0) -> None:
        """Block until every submitted batch is processed and every deferred
        publish has landed. Raises the worker's error if it died, and
        ``TimeoutError`` past ``timeout_s``."""
        deadline = time.monotonic() + timeout_s
        while True:
            # a dead worker first: an empty queue after a preempt means the
            # in-flight batch was dropped, not drained
            if self._state in ("preempted", "failed"):
                raise self._error
            if self._queue.unfinished_tasks == 0:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(
                    f"service did not drain within {timeout_s}s"
                    f" (queue depth {self._queue.qsize()})"
                )
            time.sleep(self.poll_interval_s / 2)
        self._drain_publishes(max(deadline - time.monotonic(), 0.001))

    def _await_agreement(self, timeout_s: float) -> bool:
        """Bounded wait for the agreed clock to catch this rank's local
        watermark (no-op without an agreement); polling it runs the
        straggler scan. False on timeout: the caller publishes from the local
        clock, stamped degraded."""
        if self.metric.agreement is None:
            return True
        target = self.metric.watermark
        if target is None:
            return True
        deadline = time.monotonic() + max(timeout_s, 0.001)
        while True:
            agreed = self.metric.agreed_watermark  # runs the straggler scan
            if agreed is not None and agreed >= target:
                return True
            if time.monotonic() > deadline:
                return False
            time.sleep(self.poll_interval_s / 2)

    def finalize(self, timeout_s: float = 30.0) -> Any:
        """Drain, force-publish every still-open resident window (after a
        wait for the agreement bounded by the guard's deadline) and return the
        fresh merged value, synced under the service guard."""
        self.flush(timeout_s)
        with self._proc_lock:
            head = self.metric.head_window
            if head is not None:
                wait_s = min(timeout_s, self.guard.deadline_s or timeout_s)
                if not self._await_agreement(wait_s):
                    self._wm_force_degraded = True
                try:
                    self._publish_closed(force_through=head)
                    self._drain_publishes(timeout_s)
                finally:
                    self._wm_force_degraded = False
            self.metric._computed = None
            old_guard = set_sync_guard(self.guard)
            try:
                with _device_scope(self.metric.device):
                    return self.metric.compute()
            finally:
                set_sync_guard(old_guard)

    def stop(self, timeout_s: float = 30.0) -> None:
        """Drain and stop the worker (idempotent; safe after a preempt)."""
        if self._state == "running":
            try:
                self.flush(timeout_s)
            finally:
                self._stop.set()
                self._worker.join(timeout=timeout_s)
                if self._state == "running":
                    self._state = "stopped"
        else:
            self._stop.set()
            self._worker.join(timeout=timeout_s)
            try:
                self._drain_publishes(timeout_s)
            except BaseException:  # noqa: BLE001 - surfaced by flush/snapshot on live paths
                pass

    def __enter__(self) -> "MetricService":
        return self

    def __exit__(self, *exc: Any) -> bool:
        self.stop()
        return False

    # --------------------------------------------------- snapshot / restore
    def snapshot(self) -> Dict[str, Any]:
        """Crash-safe checkpoint: the metric's ``state_dict`` plus the
        service bookkeeping, after landing the in-flight publishes. Also
        refreshed at every publish (:attr:`last_snapshot`)."""
        with self._proc_lock:
            self._drain_publishes(30.0)
            snap = self._snapshot_locked()
        self.last_snapshot = snap
        return snap

    def _snapshot_locked(self) -> Dict[str, Any]:
        return {
            "metric": self.metric.state_dict(),
            "processed": self._processed,
            "ingest_idx": self._ingest_idx,
            "published_through": self._published_through,
            "shed_events": self.shed_events,
            "publications": len(self.publications),
        }

    def restore(self, snapshot: Dict[str, Any]) -> None:
        """Load a :meth:`snapshot` (of either package) into this service and
        resume accepting events; replay from ``snapshot["processed"]``, or
        from earlier with the original ``seq=`` ids."""
        self._drain_publishes(30.0)  # stale deferred publishes land first
        with self._proc_lock:
            # stale queued items of a killed run belong to the lost window
            while True:
                try:
                    self._queue.get_nowait()
                    self._queue.task_done()
                except queue.Empty:
                    break
            self.metric.load_state_dict(snapshot["metric"])
            self._processed = int(snapshot["processed"])
            self._seq = self._processed
            self._ingest_idx = int(snapshot["ingest_idx"])
            published = snapshot["published_through"]
            self._published_through = None if published is None else int(published)
            self.shed_events = int(snapshot["shed_events"])
            self._shed_since_publish = 0
            self._error = None
            if not self._worker.is_alive() and not self._stop.is_set():
                self._state = "running"
                self._worker = self._start_worker()
            elif self._worker.is_alive():
                self._state = "running"
        self._note_health()

    def __repr__(self) -> str:
        return (
            f"MetricService({self.metric!r}, state={self._state!r},"
            f" health={self.health!r}, processed={self._processed})"
        )


def _item_samples(item: tuple) -> int:
    """Sample count of one queued submission (the drain's sample bound): the
    leading axis of its first data argument, 1 for scalars."""
    _, args, _, kwargs = item
    data = (*args, *kwargs.values())
    if not data:
        return 1
    first = data[0]
    return int(first.shape[0]) if getattr(first, "ndim", 0) else 1


def _concat(parts: List[Any]) -> Any:
    """One span argument: tensors joined on their device, host arrays on the host."""
    if isinstance(parts[0], Tensor):
        return torch.cat(parts)
    return np.concatenate(parts)


def _span_profile(args: tuple, times: np.ndarray, kwargs: dict):
    """``(data, per_sample_times, structure_key)`` when one queued batch is
    span-eligible, else ``None``: every data argument an array or tensor
    sharing one non-empty leading axis, and one float64 stamp per sample. The
    structure key (argument count, kwarg keys, each argument's kind, dtype,
    trailing shape and device) must match across a span, so the
    concatenation is exact."""
    data = (*args, *kwargs.values())
    if not data:
        return None
    n = None
    host_data = []
    kinds = []
    for a in data:
        if not getattr(a, "ndim", 0):
            return None
        if isinstance(a, Tensor):
            arr = a
            kinds.append(("tensor", str(a.dtype), tuple(a.shape[1:]), str(a.device)))
        else:
            arr = np.asarray(a)
            kinds.append(("array", arr.dtype.str, arr.shape[1:], "host"))
        if n is None:
            n = int(arr.shape[0])
            if n == 0:
                return None
        elif int(arr.shape[0]) != n:
            return None
        host_data.append(arr)
    t = np.asarray(times, dtype=np.float64).reshape(-1)
    if t.size == 1 and n > 1:
        t = np.full(n, t[0])
    if t.size != n:
        return None
    struct = (len(args), tuple(kwargs), tuple(kinds))
    return tuple(host_data), t, struct
