"""Counterpart of ``metrics_tpu/observability/lifecycle.py``, copied: the same
stages, clock, first-wins / last-wins rules, derived gauges and bounded FIFO.
In the port, ``wrappers/windowed.py`` stamps ``first_event`` / ``last_event``;
the serving stages are stamped by the serving runtime, which is ported next.

Window-lifecycle stage ledger: where every published window spent its time.

Every window flowing through the serving stack crosses the same stages, on
different threads:

    first_event -> last_event -> closed -> sync_started -> sync_done
        -> published [-> merged] [-> banked]

``first_event``/``last_event`` are stamped by ``wrappers/windowed.py`` as
events route into the window's slab; ``closed`` by the service worker as the
watermark verdict lands; ``sync_started``/``sync_done``/``published`` by the
publish stage (the deferred host plane by default — the shadow-twin path
stamps identically, because the stamp keys on the SERVICE label, not the
metric instance); ``merged`` by the fleet merge tier on every contributing
shard's ledger; ``banked`` by the retention store's ingest. All stamps are
``time.perf_counter_ns()`` — the span tracer's clock, so ledger times and
trace times compare directly.

From the ledger this module derives, at the moment ``published`` lands:

- **per-stage latencies** (ingest span, close wait, dispatch wait, guarded
  sync, publish tail) and the **end-to-end close -> publish latency** —
  each fed into the per-label :class:`~metrics_tpu_torch.observability.selfmeter.
  LatencyMeter` sketches (constant bytes, certified p50/p95/p99) and pushed
  into the counters' enabled-gated ``selfmeter`` gauge block;
- the ``lifecycle`` gauge block (windows fully stamped, windows still open,
  last end-to-end ms) and the ``publish_staleness`` stamp (seconds since
  the label last published — derived at snapshot time so staleness keeps
  aging between publishes).

``merged``/``banked`` stamps feed the ``merge``/``bank`` stage meters the
same way as they land. Watermark lag (host now - agreed watermark) is a
separate gauge recorded by the publish path itself
(``counters.record_watermark_lag``): it compares event time against wall
time, which only the service knows how to interpret.

The ledger is bounded (:data:`LEDGER_CAP` windows, FIFO eviction) so an
unbounded stream holds a constant ledger footprint, and enabled-gated like
the span tracer: ``observability.enable()`` turns it on with the counters,
``reset()`` clears it together with the self-meter registry.

**Flow ids** live here too: :func:`next_flow_id` hands the publish path a
process-unique id that travels inside the publish book through the deferred
host plane, onto the ``service.publish`` span's attrs and the publication
record, and into the fleet's merged record as the list of contributing shard
flows — ``export.to_trace_events`` turns spans sharing a flow id into
Chrome-trace flow arrows, so Perfetto draws ingest -> publish causality
across threads that thread-local span parentage cannot express.
"""
import itertools
import threading
import time
from collections import OrderedDict
from typing import Any, Dict, Optional, Tuple

from metrics_tpu_torch.observability.counters import (
    record_lifecycle,
    record_publish_stamp,
    record_selfmeter,
)
from metrics_tpu_torch.observability.selfmeter import SELFMETER

__all__ = [
    "CORE_STAGES",
    "LEDGER",
    "LEDGER_CAP",
    "STAGES",
    "STAGE_SPANS",
    "next_flow_id",
    "stamp",
]

# the full stage vocabulary, in pipeline order; merged/banked only appear
# when a fleet merge tier / retention store is attached downstream
STAGES = (
    "first_event",
    "last_event",
    "closed",
    "sync_started",
    "sync_done",
    "published",
    "merged",
    "banked",
)

# the stages every published window must carry — the --check-health gate's
# "complete ledger" (merged/banked are attachment-dependent extras)
CORE_STAGES = STAGES[:6]

# (meter stage name, from stamp, to stamp): the latency spans derived as
# ``published`` lands. ``e2e`` is the headline close -> publish latency.
STAGE_SPANS = (
    ("ingest", "first_event", "last_event"),
    ("close", "last_event", "closed"),
    ("dispatch", "closed", "sync_started"),
    ("sync", "sync_started", "sync_done"),
    ("publish", "sync_done", "published"),
    ("e2e", "closed", "published"),
)

# bounded ledger: enough for every resident window of every label in any
# realistic process, constant regardless of stream length
LEDGER_CAP = 4096

_flow_ids = itertools.count(1)


def next_flow_id() -> int:
    """A process-unique flow id for one window's ingest -> publish arc."""
    return next(_flow_ids)


class _Ledger:
    """The process-wide stage ledger; ``LEDGER.enabled`` is the hot-path
    gate (callers check it before building any stamp arguments)."""

    __slots__ = ("enabled", "_lock", "_entries", "_stamped")

    def __init__(self) -> None:
        self.enabled = False
        self._lock = threading.Lock()
        # (label, window) -> {stage: perf_counter_ns}, insertion-ordered
        self._entries: "OrderedDict[Tuple[str, int], Dict[str, int]]" = OrderedDict()
        self._stamped: Dict[str, int] = {}  # label -> windows fully core-stamped

    # ------------------------------------------------------------ stamping
    def stamp(self, label: str, window: int, stage: str, ns: Optional[int] = None) -> None:
        """Stamp one stage of one window's ledger (monotonic clock).

        ``first_event`` and the close/sync/publish stages are first-wins
        (an idempotent replay or a duplicate close cannot rewrite history);
        ``last_event`` is last-wins by definition. ``published`` triggers
        the derivation: stage latencies into the self-meter sketches, the
        ``lifecycle``/``selfmeter`` gauge blocks, the staleness stamp.
        """
        if stage not in STAGES:
            raise ValueError(f"unknown lifecycle stage {stage!r}; expected one of {STAGES}")
        if ns is None:
            ns = time.perf_counter_ns()
        key = (str(label), int(window))
        derived: Optional[Dict[str, int]] = None
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                entry = self._entries[key] = {}
                while len(self._entries) > LEDGER_CAP:
                    self._entries.popitem(last=False)
            if stage == "last_event":
                entry[stage] = ns
            else:
                entry.setdefault(stage, ns)
            if stage in ("published", "merged", "banked") and entry.get(stage) == ns:
                derived = dict(entry)
        if derived is not None:
            self._derive(key[0], key[1], stage, derived)

    def _derive(self, label: str, window: int, stage: str, entry: Dict[str, int]) -> None:
        """Feed the self-meter sketches and gauge blocks as a window crosses
        ``published`` (the six core spans) or ``merged``/``banked`` (the
        downstream extras, measured from the previous landed stage)."""
        if stage == "published":
            for name, lo, hi in STAGE_SPANS:
                if lo in entry and hi in entry:
                    summary = SELFMETER.observe(
                        label, name, max(entry[hi] - entry[lo], 0) / 1e6
                    )
                    record_selfmeter(label, name, summary)
            complete = all(s in entry for s in CORE_STAGES)
            with self._lock:
                if complete:
                    self._stamped[label] = self._stamped.get(label, 0) + 1
                stamped = self._stamped.get(label, 0)
                open_windows = sum(
                    1
                    for (lab, _), e in self._entries.items()
                    if lab == label and "published" not in e
                )
            e2e_ms = (
                max(entry["published"] - entry["closed"], 0) / 1e6
                if "closed" in entry else 0.0
            )
            record_lifecycle(label, stamped, open_windows, e2e_ms)
            record_publish_stamp(label, entry["published"])
        else:
            prev = "published" if stage == "merged" else "merged"
            base = entry.get(prev, entry.get("published"))
            if base is not None:
                name = "merge" if stage == "merged" else "bank"
                summary = SELFMETER.observe(label, name, max(entry[stage] - base, 0) / 1e6)
                record_selfmeter(label, name, summary)

    # ------------------------------------------------------------- reading
    def entry(self, label: str, window: int) -> Optional[Dict[str, int]]:
        """One window's stage stamps (a copy), or None."""
        with self._lock:
            entry = self._entries.get((str(label), int(window)))
            return dict(entry) if entry is not None else None

    def latencies(self, label: str, window: int) -> Dict[str, float]:
        """The derived per-stage latencies (ms) a window's ledger supports
        so far — empty when the window is unknown."""
        entry = self.entry(label, window)
        if entry is None:
            return {}
        out: Dict[str, float] = {}
        for name, lo, hi in STAGE_SPANS:
            if lo in entry and hi in entry:
                out[name] = max(entry[hi] - entry[lo], 0) / 1e6
        if "merged" in entry and "published" in entry:
            out["merge"] = max(entry["merged"] - entry["published"], 0) / 1e6
        if "banked" in entry:
            base = entry.get("merged", entry.get("published"))
            if base is not None:
                out["bank"] = max(entry["banked"] - base, 0) / 1e6
        return out

    def ledgers(self, label: Optional[str] = None) -> Dict[Any, Dict[str, int]]:
        """All ledger entries (copies): ``{window: stamps}`` for one label,
        ``{(label, window): stamps}`` otherwise."""
        with self._lock:
            if label is None:
                return {key: dict(e) for key, e in self._entries.items()}
            return {
                window: dict(e)
                for (lab, window), e in self._entries.items()
                if lab == label
            }

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._stamped.clear()


LEDGER = _Ledger()


def stamp(label: str, window: int, stage: str, ns: Optional[int] = None) -> None:
    """Module-level stamp helper: one attribute load + falsy branch when the
    ledger is disabled (the span-tracer calling convention)."""
    if LEDGER.enabled:
        LEDGER.stamp(label, window, stage, ns)


def enable() -> None:
    LEDGER.enabled = True


def disable() -> None:
    LEDGER.enabled = False


def is_enabled() -> bool:
    return LEDGER.enabled


def clear() -> None:
    """Drop every ledger entry and self-meter sketch."""
    LEDGER.clear()
    SELFMETER.clear()
