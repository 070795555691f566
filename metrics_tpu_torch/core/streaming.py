"""Streaming-plane core: the sum / count base and the windowed-serving math.

Counterpart of ``metrics_tpu/core/streaming.py``. Two things live here:

1. :class:`SumCountMetric`, the base of the metrics that reduce to "sum of
   per-sample statistics divided by a count": a float32 ``total`` and an
   int64 ``count``, both "sum" states.

2. The windowed serving-plane math: :class:`WindowSpec` (tumbling or sliding
   windows over a ring of ``num_windows`` slots, with an
   ``allowed_lateness_s`` grace), :func:`route_events` (the
   watermark-advancing event router every ``Windowed.update`` runs),
   :func:`decay_scale` (the exponential time-decay factor) and
   :class:`WatermarkAgreement` (the cross-rank low-watermark registry). They
   are pure host numpy, carried over from the JAX package in their
   arithmetic: a routing verdict is data-dependent host work by
   construction, while the scatter that consumes the slot ids runs on the
   device (``wrappers/windowed.py``).

Routing contract: for one batch the watermark first advances to
``max(old watermark, max(event_time))``; an event is then accepted iff its
window is still open, ``window_start + window_s + allowed_lateness_s >
watermark`` (head-window events are never late), and its ring slot is still
resident. Accepted events route to ``window % num_windows``; rejected events
get slot ``-1``, dropped by the slab scatter and counted
(``slab_dropped_samples``), never misrouted. A verdict depends only on the
event's window and the running watermark maximum, so a shuffled stream whose
events all stay within the allowed lateness gives the same slabs bit for
bit.

Sliding windows (``WindowSpec(slide_s=...)``): window ``w`` covers
``[w*slide_s, w*slide_s + window_s)``, each event belongs to ``window_s /
slide_s`` consecutive windows, and :func:`route_events` emits one slot row
per covering window, each judged by the same open rule. The agreed clock
(``route_events(..., agreed=)``) judges verdicts against the cross-rank
agreed (global-min) watermark instead of the local running max, while the
local watermark still drives ring residency.
"""
import inspect
import itertools
import math
import threading
import time
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.observability.counters import (
    record_watermark_agreement,
    record_wm_exchange,
    record_wm_straggler,
)
from metrics_tpu_torch.utils.exceptions import SyncTimeoutError

__all__ = [
    "RouteResult",
    "SumCountMetric",
    "WatermarkAgreement",
    "WindowSpec",
    "decay_scale",
    "route_events",
    "window_index",
]


class SumCountMetric(Metric):
    """``compute() = _finalize(total / max(count, 1))`` over streaming sum states.

    Subclasses implement ``_update_stats(*args, **kwargs) -> (sum, count)``
    (count may be an int or an integer tensor) and optionally
    ``_finalize(mean) -> value``.
    """

    def __init__(
        self,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )
        self.add_state("total", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("count", default=torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")

    def _wrap_methods(self) -> None:
        super()._wrap_methods()
        # ``update`` forwards everything to ``_update_stats``: filter a collection's keyword
        # arguments by what that takes, so a member that reads ``img=`` can share the call
        self._update_signature = inspect.signature(self._update_stats)

    def _update_stats(self, *args: Any, **kwargs: Any) -> Tuple[Tensor, Any]:
        raise NotImplementedError  # pragma: no cover - subclasses define it

    def _finalize(self, mean: Tensor) -> Tensor:
        return mean

    def update(self, *args: Any, **kwargs: Any) -> None:
        total, count = self._update_stats(*args, **kwargs)
        self.total = self.total + total
        self.count = self.count + count

    def compute(self) -> Tensor:
        return self._finalize(self.total / torch.clamp_min(self.count, 1).to(torch.float32))


# --------------------------------------------------- windowed serving plane
class WindowSpec(NamedTuple):
    """Tumbling- or sliding-window layout of the windowed serving plane.

    ``window_s`` seconds per window over a ring of ``num_windows`` slots;
    window ``w`` covers ``[w*stride, w*stride + window_s)`` and lives in slot
    ``w % num_windows``, where the stride is ``slide_s`` when set (SLIDING
    windows: a new window opens every ``slide_s`` seconds, each event covers
    ``window_s / slide_s`` consecutive windows) and ``window_s`` otherwise
    (tumbling: disjoint windows, one covering window per event).
    ``allowed_lateness_s`` is how far behind the watermark an event may
    arrive and still be routed to its (still-open) window. Lateness is
    capped at ``num_windows * stride - window_s`` (for tumbling windows:
    ``(num_windows - 1) * window_s``) — beyond that a within-lateness
    event's slot could already be recycled, which would misroute it into a
    newer window (the one failure mode the plane promises never happens).
    """

    window_s: float
    num_windows: int
    allowed_lateness_s: float = 0.0
    slide_s: Optional[float] = None

    @property
    def stride(self) -> float:
        """Seconds between consecutive window starts (= ``window_s`` for
        tumbling windows)."""
        return float(self.window_s if self.slide_s is None else self.slide_s)

    @property
    def overlap(self) -> int:
        """How many consecutive windows cover one event
        (``window_s / stride``; 1 for tumbling windows)."""
        return int(round(float(self.window_s) / self.stride))

    def window_start(self, window: int) -> float:
        """Event-time start of window ``window`` (``window * stride``)."""
        return window * self.stride

    def validate(self) -> "WindowSpec":
        if not (isinstance(self.window_s, (int, float)) and self.window_s > 0):
            raise ValueError(f"`window_s` must be a positive number, got {self.window_s!r}")
        if not (isinstance(self.num_windows, int) and self.num_windows >= 1):
            raise ValueError(f"`num_windows` must be a positive int, got {self.num_windows!r}")
        if not (isinstance(self.allowed_lateness_s, (int, float)) and self.allowed_lateness_s >= 0):
            raise ValueError(
                f"`allowed_lateness_s` must be >= 0, got {self.allowed_lateness_s!r}"
            )
        if self.slide_s is not None:
            if not (isinstance(self.slide_s, (int, float)) and 0 < self.slide_s <= self.window_s):
                raise ValueError(
                    f"`slide_s` must be a positive number <= window_s ({self.window_s}),"
                    f" got {self.slide_s!r}"
                )
            ratio = float(self.window_s) / float(self.slide_s)
            if abs(ratio - round(ratio)) > 1e-9:
                raise ValueError(
                    f"`window_s` ({self.window_s}) must be an integer multiple of"
                    f" `slide_s` ({self.slide_s}) so each event covers a whole number"
                    " of windows"
                )
            if self.num_windows < self.overlap:
                raise ValueError(
                    f"num_windows={self.num_windows} is smaller than the overlap"
                    f" factor window_s/slide_s={self.overlap}; one event's covering"
                    " windows would collide in the ring"
                )
        horizon = self.num_windows * self.stride - float(self.window_s)
        if self.allowed_lateness_s > horizon:
            raise ValueError(
                f"allowed_lateness_s={self.allowed_lateness_s} exceeds the ring's"
                f" still-open horizon (num_windows x stride - window_s ="
                f" {horizon}s); a within-lateness event"
                " could land in a recycled slot. Raise num_windows or shrink the"
                " lateness."
            )
        return self


def window_index(event_times: Any, window_s: float) -> np.ndarray:
    """Window index of each event time: ``floor(t / window_s)`` (int64)."""
    t = np.asarray(event_times, dtype=np.float64)
    return np.floor_divide(t, float(window_s)).astype(np.int64)


class RouteResult(NamedTuple):
    """One batch's routing verdict (see the module docstring contract).

    ``slot_ids``: int32 per-sample slot for the NEWEST covering window,
    ``-1`` for dropped events, which ``Windowed`` leaves out of the
    scatter. ``watermark``/``head``: the advanced LOCAL
    stream position AFTER this batch (the head is in stride units).
    ``opened``: window indices newly opened by this batch, oldest first —
    their ring slots hold expired windows and must be reset BEFORE the
    scatter. ``n_dropped``/``n_late``: fully-dropped events (no covering
    window accepted) vs accepted-but-late ROUTINGS — (event, window) pairs
    whose window span had already ended by the judging clock (the agreed
    watermark when one governs the stream), summed across the newest and
    overlap rows. ``min_window``: the oldest
    window this batch accepted an event into (``None`` if every event
    dropped) — the wrapper's stream-origin bookkeeping, so windows before
    the first event are never reported as resident. ``overlap_slots``: for
    sliding windows, one additional int32 slot row per OLDER covering window
    (``overlap - 1`` rows, each judged independently by the open rule);
    empty for tumbling windows.
    """

    slot_ids: np.ndarray
    watermark: float
    head: int
    opened: Tuple[int, ...]
    n_dropped: int
    n_late: int
    min_window: Optional[int]
    overlap_slots: Tuple[np.ndarray, ...] = ()


def route_events(
    event_times: Any,
    watermark: Optional[float],
    head: Optional[int],
    spec: WindowSpec,
    agreed: Optional[float] = None,
    judge_prefix: Optional[Any] = None,
) -> RouteResult:
    """Route one batch of event times through the advancing watermark.

    ``watermark``/``head`` are the LOCAL stream position before the batch
    (``None`` on the very first batch). ``agreed`` is the cross-rank agreed
    (global-min) watermark when a :class:`WatermarkAgreement` governs the
    stream: open/late verdicts are then judged against IT instead of the
    local running max — "late" means the same thing on every rank, and a
    rank whose local clock runs ahead cannot close a window its peers still
    feed. The local watermark (and the ring head it implies) still advances
    as before: it is this rank's contribution to the next agreement round,
    and ring-slot residency must follow the events this rank actually holds.
    Pure host numpy — deterministic, thread-free, and independently
    recomputable from the raw stream.

    ``judge_prefix`` is the coalesced-ingest form: a ``(N,)`` float64 array
    of PER-EVENT judging watermarks — for a concatenation of k sequential
    batches, every event of batch i carries the running max the sequential
    plane would have judged batch i by (``max(watermark, t_1.max(), ...,
    t_i.max())``, batch-granular and non-decreasing). Open/late verdicts are
    then judged per event against that prefix clock instead of one scalar,
    which makes routing the concatenation bit-exact vs routing the k batches
    one at a time — PROVIDED the concatenation does not advance the ring
    head or the close horizon mid-span (a coalescing caller splits spans at
    exactly those boundaries; residency is judged against the final head,
    which equals every per-batch head within such a span). Mutually
    exclusive with ``agreed``: under an agreed clock every batch is judged
    by the same scalar and coalescing's prefix form is a no-op.
    """
    stride = spec.stride
    t = np.asarray(event_times, dtype=np.float64).reshape(-1)
    if agreed is not None and judge_prefix is not None:
        raise ValueError(
            "judge_prefix and agreed are mutually exclusive: an agreed clock "
            "judges every event by the same scalar"
        )
    if t.size == 0:
        return RouteResult(
            np.empty((0,), dtype=np.int32),
            -math.inf if watermark is None else watermark,
            -1 if head is None else head,
            (),
            0,
            0,
            None,
        )
    if not np.isfinite(t).all():
        raise ValueError("event_time must be finite (got NaN/inf timestamps)")
    new_wm = float(t.max()) if watermark is None else max(float(watermark), float(t.max()))
    # the judging clock: the agreed watermark when one governs the stream
    # (verdicts are a pure function of (window, agreed)), the local running
    # max otherwise
    judge_wm: Any = new_wm if agreed is None else float(agreed)
    if judge_prefix is not None:
        jp = np.asarray(judge_prefix, dtype=np.float64).reshape(-1)
        if jp.shape != t.shape:
            raise ValueError(
                f"judge_prefix must match event_times: {jp.shape} vs {t.shape}"
            )
        if jp.size and (np.diff(jp) < 0).any():
            raise ValueError("judge_prefix must be non-decreasing (a running max)")
        if float(jp[-1]) != new_wm:
            raise ValueError(
                f"judge_prefix must end at the batch watermark: {float(jp[-1])}"
                f" != {new_wm}"
            )
        judge_wm = jp
    new_head = int(math.floor(new_wm / stride))
    w = window_index(t, stride)  # the NEWEST window covering each event

    def verdict(cover: np.ndarray) -> np.ndarray:
        # a covering window is accepted iff it is still open — it stays open
        # for allowed_lateness_s past its end, judged by the agreed clock
        # when there is one — AND its ring slot is still resident. The
        # validated lateness cap makes an open window's slot resident by
        # construction on a single clock; with an agreed clock behind the
        # local head, an open window can have fallen off the local ring —
        # the residency guard then drops (and counts) instead of misrouting.
        open_ = cover * stride + spec.window_s + spec.allowed_lateness_s > judge_wm
        return open_ & (cover > new_head - spec.num_windows)

    def late(cover: np.ndarray, ok: np.ndarray) -> int:
        # a late routing: an accepted (event, window) pair whose window span
        # had already ended by the JUDGING clock — the same clock the open
        # verdict used, so "late" means the same thing on every rank under
        # an agreement (and nothing is late before one forms: pre-agreement
        # judge_wm is -inf, no span has ended yet)
        return int((ok & (cover * stride + spec.window_s <= judge_wm)).sum())

    accepted = verdict(w)
    slot_ids = np.where(accepted, w % spec.num_windows, -1).astype(np.int32)
    any_accepted = accepted
    min_w = w[accepted].min() if accepted.any() else None
    n_late = late(w, accepted)
    overlap_rows = []
    for j in range(1, spec.overlap):
        cover = w - j
        ok = verdict(cover)
        overlap_rows.append(np.where(ok, cover % spec.num_windows, -1).astype(np.int32))
        any_accepted = any_accepted | ok
        n_late += late(cover, ok)
        if ok.any():
            older = cover[ok].min()
            min_w = older if min_w is None else min(min_w, older)
    n_dropped = int((~any_accepted).sum())
    min_window = None if min_w is None else int(min_w)
    if head is None or head < new_head - spec.num_windows:
        # first batch, or a jump past the whole ring: every slot the new
        # horizon can see starts fresh
        opened = tuple(range(new_head - spec.num_windows + 1, new_head + 1))
    else:
        opened = tuple(range(head + 1, new_head + 1))
    return RouteResult(
        slot_ids, new_wm, new_head, opened, n_dropped, n_late, min_window,
        tuple(overlap_rows),
    )


def decay_scale(dt_s: Any, half_life_s: float) -> Any:
    """Exponential time-decay factor ``0.5 ** (dt / half_life)``.

    The decay accumulator's two uses: scaling the whole accumulator forward
    by the watermark advance, and weighting each sample's delta by its age
    relative to the new watermark (``dt = watermark - event_time``).
    """
    return 0.5 ** (np.asarray(dt_s, dtype=np.float64) / float(half_life_s))


# ------------------------------------------------ cross-rank watermark plane
def _world_size() -> int:
    """The ``torch.distributed`` world size, 1 without an initialized group."""
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


class WatermarkAgreement:
    """Cross-rank low-watermark agreement: the Dataflow-style fix for skewed
    and stalled event clocks on a multi-rank stream.

    Each rank of a distributed stream reports its LOCAL running-max
    watermark (:meth:`report`); the AGREED watermark (:meth:`agreed`) is the
    minimum over every participating rank — so a window closes, publishes,
    or recycles only once *every* rank's clock has passed it, and a skewed
    rank can no longer close a window its peers still feed. The agreed value
    is monotone non-decreasing by construction (a restored or lagging report
    can never regress it).

    **Transport.** Within one process the registry IS the agreement — every
    ``report`` is a dict store, and ``agreed()`` is a min over the registry
    (deterministic, lock-cheap). :meth:`exchange` is the cross-process round;
    in one process it is the identity (counted, already resolved). Across
    processes it is one ``all_reduce`` (min) of this process's contribution,
    entered on the caller's thread and folded into the registry by the host
    plane's worker (``parallel/deferred.deferred_host_gather``) under
    ``guard``; a degraded round keeps the local view. In one process the
    cadence is every ``exchange_every_s`` seconds of wall clock (0 = every
    report), with at most one exchange in flight. Across processes a round is
    a collective that every process must enter equally often, so rounds are
    dispatched only by explicit :meth:`exchange` calls, made at the same
    points of every process's program, and never skipped; ``report`` only
    records.

    **Stragglers.** Agreement must never deadlock the fleet: a rank whose
    watermark stops advancing for ``deadline_s`` wall-clock seconds is
    EXCLUDED from the min (policy ``"degrade"``, the default) — the
    process-wide ``wm_stragglers`` counter bumps once per exclusion episode,
    :attr:`degraded` latches True so affected publishes can stamp
    ``degraded=True``, and window closing proceeds on the surviving ranks'
    clocks. A rank that reports an ADVANCING watermark again rejoins
    automatically (its fresh value re-enters the min — which cannot regress
    the agreed high-water), and so does a rank that RE-REGISTERS — a
    recovered participant re-attaching under its old rank rejoins even
    though its restored report equals the pre-crash value. Policy
    ``"raise"`` throws
    :class:`~metrics_tpu_torch.utils.exceptions.SyncTimeoutError` from
    ``agreed()`` instead, for callers that prefer failing loudly over
    publishing degraded values.

    Args:
        deadline_s: how long a rank's watermark may stall before exclusion
            (``None`` disables exclusion — a stalled rank then holds the
            agreed clock forever; only safe when something else bounds it).
        policy: ``"degrade"`` (exclude + count + latch) or ``"raise"``.
        exchange_every_s: minimum wall-clock spacing between exchange rounds
            dispatched by ``report`` in one process (0 dispatches one per
            report, subject to the single-in-flight guard).
        guard: the :class:`~metrics_tpu_torch.parallel.sync.SyncGuard` of the
            cross-process rounds (default: the process-wide guard at dispatch).
        label: gauge label (``watermark_agreement`` in counters snapshots);
            auto-indexed when omitted.
    """

    _ids = itertools.count()

    def __init__(
        self,
        deadline_s: Optional[float] = 30.0,
        policy: str = "degrade",
        exchange_every_s: float = 0.0,
        guard: Optional[Any] = None,
        label: Optional[str] = None,
    ) -> None:
        if deadline_s is not None and not (
            isinstance(deadline_s, (int, float)) and deadline_s > 0
        ):
            raise ValueError(f"`deadline_s` must be a positive number or None, got {deadline_s!r}")
        if policy not in ("degrade", "raise"):
            raise ValueError(f"`policy` must be 'degrade' or 'raise', got {policy!r}")
        if not (isinstance(exchange_every_s, (int, float)) and exchange_every_s >= 0):
            raise ValueError(f"`exchange_every_s` must be >= 0, got {exchange_every_s!r}")
        self.deadline_s = None if deadline_s is None else float(deadline_s)
        self.policy = policy
        self.exchange_every_s = float(exchange_every_s)
        self.guard = guard
        self.label = label or f"WatermarkAgreement#{next(WatermarkAgreement._ids)}"
        self._lock = threading.RLock()
        # rank -> {"wm": float|None, "stamp": monotonic seconds of last ADVANCE}
        self._ranks: Dict[Any, Dict[str, Any]] = {}
        self._excluded: set = set()
        self._agreed: Optional[float] = None  # monotone high-water of the min
        self._remote: Optional[float] = None  # last exchanged cross-process min
        self._remote_hold = False  # a peer process holds the agreement open (a rank yet to report)
        self._folded = False  # a cross-process round has been folded in
        self._inflight: Optional[Any] = None  # the last exchange round's SyncHandle
        self._last_exchange = time.monotonic()  # cadence counts from construction
        self.stragglers = 0  # lifetime exclusion episodes
        self.exchanges = 0  # lifetime exchange rounds dispatched

    # ------------------------------------------------------------ reporting
    def register(self, rank: Any) -> None:
        """Declare a participant before its first report. A registered rank
        with no watermark yet HOLDS the agreement open (``agreed()`` stays at
        its last value) until it reports or stalls past the deadline — the
        "window held open by a peer that has not spoken yet" case.

        Re-registering an EXISTING rank (a recovered shard re-attaching
        under its old rank) is a liveness signal: the deadline stamp
        refreshes and any straggler exclusion lifts immediately. The
        restored report typically EQUALS the pre-crash watermark —
        ``report`` alone would not treat it as an advance, and the
        recovered-and-healthy rank would otherwise stay excluded until a
        strictly newer event arrives (forever, on an ended stream)."""
        with self._lock:
            entry = self._ranks.get(rank)
            if entry is None:
                self._ranks[rank] = {"wm": None, "stamp": time.monotonic()}
                return
            entry["stamp"] = time.monotonic()
            if rank in self._excluded:
                self._excluded.discard(rank)
                self._note_gauge_locked()

    def report(self, rank: Any, watermark: float) -> None:
        """Fold one rank's local running-max watermark into the registry
        (monotone per rank: a lower report is a no-op, never a regression)
        and dispatch an exchange round if the cadence is due."""
        wm = float(watermark)
        with self._lock:
            entry = self._ranks.setdefault(rank, {"wm": None, "stamp": time.monotonic()})
            if entry["wm"] is None or wm > entry["wm"]:
                entry["wm"] = wm
                entry["stamp"] = time.monotonic()
        self._maybe_exchange()

    def ranks(self) -> Tuple[Any, ...]:
        with self._lock:
            return tuple(self._ranks)

    def local_watermarks(self) -> Dict[Any, Optional[float]]:
        """Every participant's last reported local watermark (the gate's
        publish-ordering assertions read this)."""
        with self._lock:
            return {rank: entry["wm"] for rank, entry in self._ranks.items()}

    # ------------------------------------------------------------ agreement
    def agreed(self) -> Optional[float]:
        """The agreed (global-min) watermark: min over every included rank's
        report, folded with the last cross-process exchange, monotone
        non-decreasing. ``None`` until a first agreement forms (no rank has
        reported yet, or a registered rank is still silent within its
        deadline)."""
        with self._lock:
            candidate = self._included_min_locked()
            # across processes the other processes' clocks hold the agreement open until a first round lands
            if candidate is not None and not self._remote_hold and (self._folded or _world_size() == 1):
                if self._remote is not None:
                    candidate = min(candidate, self._remote)
                if self._agreed is None or candidate > self._agreed:
                    self._agreed = candidate
            return self._agreed

    def _included_min_locked(self) -> Optional[float]:
        """Min over non-straggling ranks, running the exclusion scan (the
        deadline judgment) as a side effect. ``None`` when no agreement can
        form yet."""
        now = time.monotonic()
        values = []
        pending = False
        for rank, entry in self._ranks.items():
            stale = (
                self.deadline_s is not None
                and now - entry["stamp"] > self.deadline_s
            )
            if stale:
                if self.policy == "raise":
                    raise SyncTimeoutError(
                        f"watermark agreement {self.label!r}: rank {rank!r} stalled"
                        f" past deadline_s={self.deadline_s} (policy='raise')"
                    )
                if rank not in self._excluded:
                    self._excluded.add(rank)
                    self.stragglers += 1
                    record_wm_straggler()
                    self._note_gauge_locked()
                continue
            if rank in self._excluded:
                # a fresh advance within the deadline: the straggler rejoins
                self._excluded.discard(rank)
                self._note_gauge_locked()
            if entry["wm"] is None:
                pending = True
                continue
            values.append(entry["wm"])
        if pending or not values:
            return None
        return min(values)

    @property
    def degraded(self) -> bool:
        """True while any participant is excluded as a straggler — publishes
        judged by a clock a rank no longer feeds should say so."""
        with self._lock:
            return bool(self._excluded)

    def excluded(self) -> Tuple[Any, ...]:
        """The currently-excluded (straggling) ranks."""
        with self._lock:
            return tuple(sorted(self._excluded, key=repr))

    # -------------------------------------------------------------- exchange
    def exchange(self) -> Optional[Any]:
        """Run one cross-process min-exchange round; returns its
        :class:`~metrics_tpu_torch.parallel.deferred.SyncHandle`.

        In one process (no ``torch.distributed`` group, or a world of 1) the
        registry already is the world: the round is counted and recorded
        (``wm_exchange_calls``), and the handle is already resolved to
        ``{"wm": local_min}`` (``None`` instead when a round is in flight or
        no local min exists yet), the JAX package's single-process fold,
        which changes nothing.

        Across processes every call enters one round: an ``all_reduce``
        (min, float64) of ``[local min or +inf, -1 if a registered rank of
        this process is still silent within its deadline else 0]``, entered
        here on the caller's thread, so every process must call ``exchange``
        at the same points of its program. The host plane's worker waits on
        it under ``guard`` and folds it: a silent rank anywhere holds the
        agreement open, else the exchanged min joins ``agreed()``; until a
        first round has been folded in, the agreement stays open. A process
        whose ranks are all excluded contributes ``+inf``, so a straggler
        excluded on its own process no longer holds the others back. A round
        that degrades folds this process's own contribution (the local
        view); one that raises is dropped by :meth:`drain`."""
        world = _world_size()
        with self._lock:
            if world == 1 and self._inflight is not None and not self._inflight.done():
                return None
            local_min = self._included_min_locked()
            pending = any(entry["wm"] is None for rank, entry in self._ranks.items() if rank not in self._excluded)
            if world == 1 and local_min is None:
                return None
            self.exchanges += 1
            self._last_exchange = time.monotonic()
            self._note_gauge_locked()
        record_wm_exchange()
        from metrics_tpu_torch.parallel.deferred import SyncHandle, deferred_host_gather

        if world == 1:
            handle = SyncHandle("ready", {"wm": np.asarray(local_min, dtype=np.float64)}, label="wm_exchange")
        else:
            contribution = [math.inf if local_min is None else local_min, -1.0 if pending else 0.0]
            backend = dist.get_backend()
            device = torch.device("cuda", torch.cuda.current_device()) if backend == "nccl" else torch.device("cpu")
            handle = deferred_host_gather({"wm": torch.tensor(contribution, dtype=torch.float64, device=device)},
                                          {"wm": "min"}, guard=self.guard, label="wm_exchange",
                                          finish=self._fold_exchange)
        with self._lock:
            self._inflight = handle
        return handle

    def _fold_exchange(self, result: Dict[str, Any]) -> Dict[str, Any]:
        """The exchange's ``finish`` (runs on the host plane's worker): fold
        the exchanged ``[min, hold]`` into the registry."""
        wm, hold = (float(v) for v in result["wm"].cpu())
        with self._lock:
            self._folded = True
            self._remote_hold = hold < 0
            if not self._remote_hold:
                self._remote = None if math.isinf(wm) else wm
        return result

    def _maybe_exchange(self) -> None:
        if _world_size() > 1:
            return  # across processes rounds are explicit exchange() calls (see exchange)
        if self.exchange_every_s > 0:
            with self._lock:
                if time.monotonic() - self._last_exchange < self.exchange_every_s:
                    return
        self.exchange()

    def drain(self, timeout_s: float = 30.0) -> None:
        """Bounded barrier over the in-flight exchange (shutdown never hangs
        on a dead exchange: a failed round degrades to the local registry)."""
        with self._lock:
            handle = self._inflight
        if handle is None:
            return
        try:
            handle.result(timeout_s)
        except BaseException:  # noqa: BLE001 - degrade to the local registry
            pass

    # ------------------------------------------------------------ lifecycle
    def __deepcopy__(self, memo: dict) -> "WatermarkAgreement":
        # the agreement IS the process-wide clock registry: a deep-copied
        # participant (a shadow twin, a cloned rank) must keep
        # talking to the SAME registry, not a frozen private copy — and the
        # live lock/in-flight handle could not travel anyway
        return self

    def __reduce__(self):
        raise TypeError(
            "WatermarkAgreement is a live process-wide registry (locks, an"
            " in-flight exchange) and cannot be pickled; checkpoint the"
            " participating metrics (their state_dict carries the agreed"
            " high-water) and re-attach on restore"
        )

    # --------------------------------------------------------------- gauges
    def _note_gauge_locked(self) -> None:
        record_watermark_agreement(
            self.label, self._agreed, len(self._ranks), self._excluded, self.exchanges
        )

    def __repr__(self) -> str:
        with self._lock:
            return (
                f"WatermarkAgreement(label={self.label!r}, ranks={len(self._ranks)},"
                f" agreed={self._agreed}, excluded={sorted(map(repr, self._excluded))},"
                f" exchanges={self.exchanges})"
            )
