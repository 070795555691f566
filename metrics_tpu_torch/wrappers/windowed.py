"""Windowed: the serving runtime's window plane, "AUROC over the last 5 minutes"
as a slot rotation, not a copy.

Counterpart of ``metrics_tpu/wrappers/windowed.py``. ``Windowed(metric,
window_s, num_windows)`` turns a per-sample-decomposable metric into a
tumbling-window ring: every registered state of the inner metric becomes a
``(W, *shape)`` slab (``parallel/slab.py`` with window slots in place of
segment slots), and ``update(..., event_time=)`` routes each sample to its
window by timestamp through an advancing watermark
(``core/streaming.route_events``):

- in-window events scatter into the head slot;
- late events within ``allowed_lateness_s`` go to their still-open slot;
- later events are dropped and counted (``slab_dropped_samples`` and
  :attr:`Windowed.dropped_samples`), never misrouted.

A window roll is a slot rotation: when the watermark opens window ``w``, ring
slot ``w % W`` (which held the expired window ``w - W``) is reset in place
before the scatter, and the sync rides the existing per-(dtype, op)
``all_reduce`` buckets: a step makes the unwindowed metric's collective calls
at any W. ``compute()`` merges the resident windows, ``compute_window(w)``
reads one. Sliding windows (``slide_s``) scatter each sample into every ring
row that covers it; ``decay_half_life_s`` turns the wrapper into one
exponentially time-decayed slot.

The routing is host numpy (the event times are read to the host once an
update); the per-sample deltas are the inner metric's own update under
``torch.func.vmap``, in chunks of ``keyed.DELTA_CHUNK_BYTES`` (Keyed's
``sample_chunks`` / ``per_sample_deltas``), each added into the slab rows in
place. Integer counts equal the JAX package's bit for bit; float sums may
round in another order. The inner contract is Keyed's: fixed-shape sum / mean
/ min / max states or sketch states, or a ``Keyed`` wrapper (its slabs grow a
leading window axis, ``(W, K, *item)``).

``forward`` routes the batch once, against the accumulator, so a roll resets
the accumulated rows; the batch value is the same routing scattered into a
fresh state. (The JAX package's forward runs the update on a fresh delta and
sums it into the accumulator, so its roll never reaches the accumulated rows:
ROADMAP section 3.)

Left out: the compiled bucketed ingest (``_scatter_bucketed`` /
``_build_ingest_program``; an eager port compiles nothing, and the eager path
is the same arithmetic), ``sparse_plane`` and ``_integrity_state`` (they need
``parallel/sparse.py`` and ``check_finite``).

The lifecycle ledger: with ``lifecycle_label`` set (the owning service sets
it) and the ledger enabled, every window an update's accepted samples touch
gets its ``first_event`` (first wins) and ``last_event`` (last wins) stamp,
host arithmetic over the routing the update computed anyway.
"""
import itertools
import math
import time
from copy import deepcopy
from typing import Any, Callable, Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric, State, _BufferSpec
from metrics_tpu_torch.core.streaming import WatermarkAgreement, WindowSpec, decay_scale, route_events, window_index
from metrics_tpu_torch.observability.counters import record_slab_dropped
from metrics_tpu_torch.observability.lifecycle import LEDGER as _LEDGER
from metrics_tpu_torch.parallel.cms import CMSSpec
from metrics_tpu_torch.parallel.qsketch import QSketchSpec
from metrics_tpu_torch.parallel.sketch import SketchSpec, is_sketch
from metrics_tpu_torch.parallel.slab import (
    PARTIAL_SCHEMA_VERSION,
    SLAB_SKETCH_KINDS,
    SlabSpec,
    check_partial_version,
    dropped_slot_count,
    make_slab_spec,
    scatter_rows_,
    slab_init,
    slab_merge,
    slab_rows_spec,
    slab_sync_reduce,
)
from metrics_tpu_torch.utils.data import host_copy, is_batched
from metrics_tpu_torch.utils.device import check_same_device
from metrics_tpu_torch.utils.exceptions import TracingUnsupportedError
from metrics_tpu_torch.wrappers.keyed import Keyed, _mask_untouched, _tree_map, per_sample_deltas, reset_rows_, sample_chunks

__all__ = ["Windowed"]

# the per-slot sample-count slab every Windowed wrapper carries: occupancy
# masks (the empty-slot policy), the sum-backed mean division, and in decay
# mode the exponentially decayed effective sample count
_ROWS_STATE = "windowed_rows"

_EMPTY_POLICIES = ("nan", "zero")


class _Routing(NamedTuple):
    """One batch's routing: the samples kept (host positions, ``None``: all),
    one host slot-id row per covering window (``-1``: dropped), the decay
    weights of the kept samples (``None`` in ring mode) and the decay mode's
    forward scale of the accumulator."""

    keep: Optional[np.ndarray]
    rows: Tuple[np.ndarray, ...]
    weights: Optional[np.ndarray]
    scale: float


class Windowed(Metric):
    r"""Tumbling-window (or time-decay) view of ``metric`` over event time.

    Args:
        metric: the inner metric. Its states become ``(W, *shape)`` window
            slabs; its ``update`` / ``compute`` are reused as the per-sample
            delta and the per-window finisher. The instance itself never
            accumulates.
        window_s: tumbling-window length in seconds of event time. Mutually
            exclusive with ``decay_half_life_s``.
        num_windows: W, the ring size: how many consecutive windows stay
            resident (a window's slot is recycled W windows after it opens).
        allowed_lateness_s: how far behind the watermark an event may arrive
            and still be routed to its (still-open) window; capped by
            ``WindowSpec.validate``. Later events are dropped and counted.
            Default 0 for the ring, unbounded for decay mode.
        decay_half_life_s: exponential time-decay half-life: the accumulator
            becomes one decayed slot (``sum`` / ``mean`` inner states only;
            integer sums become float32 slabs).
        empty: what ``compute()`` reports when no samples are resident:
            ``"nan"`` (default; non-float results fall back to 0) or ``"zero"``.
        slide_s: sliding windows: a new window opens every ``slide_s`` seconds,
            each spanning ``window_s`` (which ``slide_s`` must divide), so each
            event scatters into ``window_s / slide_s`` ring rows. ``compute()``
            then returns the newest full-span window.
        agreement / rank: join a :class:`~metrics_tpu_torch.core.streaming.
            WatermarkAgreement` as participant ``rank`` (see
            :meth:`attach_agreement`): verdicts are then judged by the agreed
            (global-min) watermark.

    The slabs live on the inner metric's device.

    ``update(*data, event_time=t)`` takes one timestamp per sample (seconds;
    an ``(N,)`` array or tensor, or a scalar stamping the whole batch). The
    watermark is the largest event time seen and never goes back.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy
        >>> acc = Windowed(Accuracy(device="cpu"), window_s=60.0, num_windows=2, allowed_lateness_s=60.0)
        >>> acc.update(torch.tensor([0.9, 0.2, 0.8]), torch.tensor([1, 0, 0]), event_time=[3.0, 65.0, 70.0])
        >>> round(float(acc.compute()), 4)  # both windows resident: 2 of 3 correct
        0.6667
    """

    def __init__(
        self,
        metric: Metric,
        window_s: Optional[float] = None,
        num_windows: int = 4,
        allowed_lateness_s: Optional[float] = None,
        decay_half_life_s: Optional[float] = None,
        empty: str = "nan",
        compute_on_step: Optional[bool] = None,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        slide_s: Optional[float] = None,
        agreement: Optional[WatermarkAgreement] = None,
        rank: Optional[Any] = None,
    ):
        if not isinstance(metric, Metric):
            raise ValueError(f"`metric` must be a Metric, got {type(metric).__name__}")
        if (window_s is None) == (decay_half_life_s is None):
            raise ValueError(
                "set exactly one of `window_s` (tumbling ring) or `decay_half_life_s` (exponential time-decay"
                " accumulator)"
            )
        if empty not in _EMPTY_POLICIES:
            raise ValueError(f"`empty` must be one of {_EMPTY_POLICIES}, got {empty!r}")
        super().__init__(
            compute_on_step=metric.compute_on_step if compute_on_step is None else compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=metric.device,
        )
        self.metric = metric
        self.decay = decay_half_life_s is not None
        if self.decay:
            if not (isinstance(decay_half_life_s, (int, float)) and decay_half_life_s > 0):
                raise ValueError(f"`decay_half_life_s` must be a positive number, got {decay_half_life_s!r}")
            if slide_s is not None:
                raise ValueError(
                    "`slide_s` slides the window ring; the decay accumulator has no windows — use the windowed"
                    " ring (window_s=)"
                )
            self.decay_half_life_s = float(decay_half_life_s)
            self.num_windows = 1
            self.allowed_lateness_s = math.inf if allowed_lateness_s is None else float(allowed_lateness_s)
            self._spec = None
        else:
            self.decay_half_life_s = None
            self.num_windows = int(num_windows)
            self.allowed_lateness_s = 0.0 if allowed_lateness_s is None else float(allowed_lateness_s)
            self._spec = WindowSpec(float(window_s), self.num_windows, self.allowed_lateness_s,
                                    None if slide_s is None else float(slide_s)).validate()
        self.window_s = None if self.decay else float(window_s)
        self.slide_s = None if self.decay or slide_s is None else float(slide_s)
        self.empty = empty
        self._metric_label = f"Windowed({type(metric).__name__})"
        # the lifecycle ledger's stamp key: set by the owning service (None: no stamps)
        self.lifecycle_label: Optional[str] = None

        # stream position (host metadata, checkpointed): None until the first event
        self._watermark: Optional[float] = None
        self._head: Optional[int] = None
        self._origin: Optional[int] = None  # the oldest window ever accepted into
        self._dropped = 0  # lifetime too-late drops
        self._late = 0  # lifetime accepted-but-late routings

        # the cross-rank agreed clock (attach_agreement): None = the local clock
        self._agreement: Optional[WatermarkAgreement] = None
        self._rank: Optional[Any] = None
        self._agreed_seen: Optional[float] = None  # monotone view of agreed()
        if agreement is not None:
            self.attach_agreement(agreement, rank=rank)
        elif rank is not None:
            raise ValueError("`rank` has no meaning without `agreement`")

        if not metric._defaults:
            raise ValueError("the inner metric declares no states; nothing to window")
        if _ROWS_STATE in metric._defaults:
            raise ValueError(f"the inner metric already has a state named {_ROWS_STATE!r}")
        self._slab_reduce: Dict[str, str] = {}
        for name, spec in metric._defaults.items():
            slab = self._slab_spec_for(name, spec, metric._reductions[name])
            self._slab_reduce[name] = slab.reduce
            self.add_state(name, default=slab, dist_reduce_fx=slab_sync_reduce(slab.reduce), persistent=True)
        rows_dtype = torch.float32 if self.decay else None  # decayed effective counts
        self.add_state(_ROWS_STATE, default=slab_rows_spec(self.num_windows, dtype=rows_dtype),
                       dist_reduce_fx="sum", persistent=True)

    def _slab_spec_for(self, name: str, spec: Any, fx: Any) -> SlabSpec:
        """The ``SlabSpec`` one inner state maps onto, or a loud rejection."""
        if isinstance(spec, (SketchSpec, QSketchSpec, CMSSpec)):
            if self.decay:
                raise ValueError(
                    f"state {name!r} is a sketch state; integer sketch counts have no exponential-decay form — use"
                    " the windowed ring (window_s=) for sketch metrics"
                )
            kind = "cms" if isinstance(spec, CMSSpec) else "qsketch" if isinstance(spec, QSketchSpec) else spec.kind
            return make_slab_spec(self.num_windows, torch.zeros(spec.shape, dtype=spec.dtype), "sum", kind=kind)
        if isinstance(spec, (list, _BufferSpec)) or fx == "cat" or fx is None:
            raise ValueError(
                f"state {name!r} of {type(self.metric).__name__} is a cat/list/buffer state with no per-window slab"
                " form; Windowed supports fixed-shape sum/mean/min/max states and sketch states (curve/rank"
                " metrics: construct the inner metric with approx='sketch')"
            )
        if isinstance(spec, SlabSpec):
            # a nested slab (the inner metric is a Keyed wrapper): windows wrap the
            # segment axis, (W, K, *item); scatter and merge by the slab's sync reduction
            if self.decay:
                raise ValueError(
                    f"state {name!r} is a segment slab; the decay accumulator does not nest over Keyed (its"
                    " sum-backed mean division clamps at 1 sample) — use the windowed ring"
                )
            if spec.kind in SLAB_SKETCH_KINDS:
                return make_slab_spec(self.num_windows, torch.zeros(spec.row_shape, dtype=spec.dtype), "sum",
                                      kind=spec.kind)
            template = torch.from_numpy(np.broadcast_to(spec.fill_template()[None], spec.row_shape).copy())
            return make_slab_spec(self.num_windows, template, slab_sync_reduce(spec.reduce))
        if not isinstance(spec, Tensor):
            raise ValueError(f"state {name!r} has an unsupported default kind for Windowed: {type(spec).__name__}")
        if not (isinstance(fx, str) and fx in ("sum", "mean", "min", "max")):
            raise ValueError(
                f"state {name!r} uses dist_reduce_fx={fx!r}; Windowed supports 'sum'/'mean'/'min'/'max' tensor"
                " states and sketch states"
            )
        if self.decay:
            if fx not in ("sum", "mean"):
                raise ValueError(
                    f"state {name!r} uses dist_reduce_fx={fx!r}; the exponential-decay accumulator only applies"
                    " to 'sum'/'mean'-kind states (min/max have no decayed form) — use the windowed ring instead"
                )
            if not (spec.is_floating_point() or spec.is_complex()):
                spec = spec.to(torch.float32)  # decayed accumulation needs a representable fraction
        return make_slab_spec(self.num_windows, spec, fx)

    # ------------------------------------------------------- stream position
    @property
    def watermark(self) -> Optional[float]:
        """Largest event time observed (``None`` before the first event)."""
        return self._watermark

    @property
    def head_window(self) -> Optional[int]:
        """Index of the newest open window (``None`` before the first event,
        and always in decay mode)."""
        return None if self.decay else self._head

    @property
    def dropped_samples(self) -> int:
        """Lifetime count of too-late events dropped (never misrouted)."""
        return self._dropped

    @property
    def late_samples(self) -> int:
        """Lifetime count of accepted routings into a window whose span had ended."""
        return self._late

    def resident_windows(self) -> tuple:
        """Window indices resident in the ring, oldest first, from the stream
        origin on (windows before the first accepted event never existed)."""
        if self.decay or self._head is None or self._origin is None:
            return ()
        lo = max(self._origin, self._head - self.num_windows + 1)
        return tuple(range(lo, self._head + 1))

    @property
    def window_stride(self) -> Optional[float]:
        """Seconds between window starts (``slide_s`` or ``window_s``; ``None`` in decay mode)."""
        return None if self.decay else self._spec.stride

    def window_start(self, window: int) -> float:
        """Event-time start of window ``window`` (``window * stride``)."""
        if self.decay:
            raise ValueError("the decay accumulator has no windows")
        return self._spec.window_start(window)

    # ------------------------------------------------------ the agreed clock
    _rank_ids = itertools.count()

    def attach_agreement(self, agreement: WatermarkAgreement, rank: Optional[Any] = None) -> "Windowed":
        """Join ``agreement`` as participant ``rank``: every update reports this
        rank's local running-max watermark, and verdicts are judged by the
        agreed (global-min) watermark. Until a first agreement forms the rank
        routes by its local clock."""
        if not isinstance(agreement, WatermarkAgreement):
            raise ValueError(f"`agreement` must be a WatermarkAgreement, got {type(agreement).__name__}")
        if self.decay:
            raise ValueError(
                "the decay accumulator has no windows to close; watermark agreement applies to the windowed ring"
                " (window_s=)"
            )
        self._agreement = agreement
        self._rank = rank if rank is not None else f"rank{next(Windowed._rank_ids)}"
        agreement.register(self._rank)
        if self._watermark is not None:
            agreement.report(self._rank, self._watermark)
        self._refresh_agreed()
        return self

    @property
    def agreement(self) -> Optional[WatermarkAgreement]:
        return self._agreement

    @property
    def rank(self) -> Optional[Any]:
        """This metric's participant id in the attached agreement."""
        return self._rank

    def _refresh_agreed(self) -> Optional[float]:
        """This rank's monotone view of the agreed watermark."""
        if self._agreement is None:
            return None
        agreed = self._agreement.agreed()
        if agreed is not None and (self._agreed_seen is None or agreed > self._agreed_seen):
            self._agreed_seen = agreed
        return self._agreed_seen

    @property
    def agreed_watermark(self) -> Optional[float]:
        """The agreed watermark as this rank last saw it (``None`` without an
        agreement, or before one forms)."""
        return self._refresh_agreed()

    @property
    def close_watermark(self) -> Optional[float]:
        """The clock windows close by: the agreed watermark under an agreement
        (``None`` until it forms), the local watermark otherwise."""
        if self._agreement is None:
            return self._watermark
        return self._refresh_agreed()

    @property
    def agreement_degraded(self) -> bool:
        """True while the attached agreement excludes a straggler."""
        return self._agreement is not None and self._agreement.degraded

    # ---------------------------------------------------------------- update
    def update(self, *args: Any, event_time: Any = None, judge_prefix: Any = None, **kwargs: Any) -> None:
        """Route one batch into the window slabs by event time.

        ``event_time`` (required, keyword-only): one timestamp per sample, or
        a scalar for the whole batch. Every data argument shares the leading
        sample axis. ``judge_prefix``: the coalesced-ingest form of
        :func:`~metrics_tpu_torch.core.streaming.route_events`, a per-event
        running-max watermark."""
        self._scatter(args, kwargs, self._route(args, kwargs, event_time, judge_prefix))

    def forward(self, *args: Any, event_time: Any = None, judge_prefix: Any = None, **kwargs: Any) -> Any:
        """Accumulate the batch and (if ``compute_on_step``) return its value.
        The batch is routed once, against the accumulator (a roll resets the
        accumulated rows), and scattered into a fresh state, which is merged
        into the accumulator (decay: added to the scaled accumulator) and gives
        the batch value, synced first with ``dist_sync_on_step``."""
        self._computed = None
        self._forward_cache = None
        check_same_device(self.device, *args, *kwargs.values(), event_time)
        self._note_rows(args, {**kwargs, "event_time": event_time})
        revert_to = self._pre_update_snapshot()  # before the route: a roll resets accumulated rows in place
        routing = self._route(args, kwargs, event_time, judge_prefix)
        acc = self._current_state()
        self._set_state(self.init_state())
        try:
            self._scatter(args, kwargs, routing._replace(scale=1.0))
            batch = self._current_state()
        finally:
            self._set_state(acc)
        if self.decay:
            self._set_state({name: acc[name] * routing.scale + batch[name] for name in acc})
        else:
            self._set_state(self.merge_states(acc, batch))
        self._guard_state_integrity("forward", revert_to)
        if not self.compute_on_step:
            return None
        self._forward_cache = self._compute_on(batch, sync=self.dist_sync_on_step)
        return self._forward_cache

    def _route(self, args: tuple, kwargs: Dict[str, Any], event_time: Any, judge_prefix: Any) -> _Routing:
        """Host routing of one batch: validates, advances the stream position,
        resets the recycled slots of the current state (the roll) and counts
        the drops."""
        if event_time is None:
            raise ValueError("Windowed.update requires `event_time=` (one timestamp per sample)")
        if judge_prefix is not None and self.decay:
            raise ValueError("judge_prefix has no meaning for the decay accumulator")
        data = (*args, *kwargs.values())
        if any(is_batched(a) for a in (*data, event_time)) or torch.compiler.is_compiling():
            raise TracingUnsupportedError(
                "Windowed resolves event-time routing on the host (watermark advance, window roll) and cannot run"
                " under torch.func.vmap or torch.compile; drive it eagerly — the per-state scatter still runs on"
                " the device."
            )
        if not data:
            raise ValueError("Windowed.update needs at least one data argument")
        first = data[0]
        n = int(first.shape[0]) if getattr(first, "ndim", 0) else 1
        if isinstance(event_time, Tensor):
            event_time = event_time.detach().cpu().numpy()  # one read of the times an update
        times = np.asarray(event_time, dtype=np.float64).reshape(-1)
        if times.size == 1 and n > 1:
            times = np.full(n, times[0])
        if times.size != n:
            raise ValueError(f"event_time has {times.size} entries but the batch has {n} samples")
        if isinstance(self.metric, Keyed) and not self.metric.lru and "slot" in kwargs:
            # the nested plane: the inner Keyed scatter drops out-of-range segment ids
            # under vmap, where it cannot count them; count them here from the host ids
            misrouted = dropped_slot_count(kwargs["slot"], self.metric.num_slots)
            if misrouted:
                record_slab_dropped(misrouted)
        if self.decay:
            return self._route_decay(times)
        agreed = None
        if self._agreement is not None and times.size:
            # report before judging: this batch's peak is this rank's
            # contribution to the agreement round that judges it
            peak = float(times.max())
            self._agreement.report(self._rank, peak if self._watermark is None else max(self._watermark, peak))
            agreed = self._refresh_agreed()
            if agreed is None:
                agreed = -math.inf  # no agreement yet: nothing has closed, nothing is late
        route = route_events(times, self._watermark, self._head, self._spec, agreed=agreed,
                             judge_prefix=judge_prefix)
        if route.opened and self._head is not None:
            # the roll: the recycled slots held now-expired windows
            self._reset_slots(sorted({w % self.num_windows for w in route.opened}))
        self._watermark, self._head = route.watermark, route.head
        if route.min_window is not None:
            self._origin = route.min_window if self._origin is None else min(self._origin, route.min_window)
        self._late += route.n_late
        if route.n_dropped:
            self._dropped += route.n_dropped
            record_slab_dropped(route.n_dropped)
        if _LEDGER.enabled and self.lifecycle_label is not None:
            self._stamp_lifecycle(times, route)
        rows = (route.slot_ids, *route.overlap_slots)
        accepted = np.logical_or.reduce([r >= 0 for r in rows]) if rows[0].size else np.zeros(0, bool)
        if accepted.all():
            return _Routing(None, rows, None, 1.0)
        keep = np.flatnonzero(accepted)
        return _Routing(keep, tuple(r[keep] for r in rows), None, 1.0)

    def _stamp_lifecycle(self, times: np.ndarray, route: Any) -> None:
        """The ledger's open and ingest stamps: every window this batch's
        accepted samples touched gets ``first_event`` (first wins) and
        ``last_event`` (last wins), as the JAX package stamps them."""
        accepted = np.asarray(route.slot_ids) >= 0
        touched = set()
        if accepted.any():
            touched.update(int(w) for w in np.unique(window_index(times[accepted], self._spec.stride)))
        for j, row in enumerate(route.overlap_slots):
            covered = np.asarray(row) >= 0
            if covered.any():
                touched.update(int(w) - (j + 1) for w in np.unique(window_index(times[covered], self._spec.stride)))
        now_ns = time.perf_counter_ns()
        for w in sorted(touched):
            _LEDGER.stamp(self.lifecycle_label, w, "first_event", ns=now_ns)
            _LEDGER.stamp(self.lifecycle_label, w, "last_event", ns=now_ns)

    def _route_decay(self, times: np.ndarray) -> _Routing:
        """The decay accumulator's routing: the accepted samples, their weights
        (float64 arithmetic, cast to float32) and the accumulator's scale."""
        new_wm = float(times.max()) if self._watermark is None else max(self._watermark, float(times.max()))
        accepted = times >= new_wm - self.allowed_lateness_s
        dropped = int((~accepted).sum())
        if dropped:
            self._dropped += dropped
            record_slab_dropped(dropped)
        scale = 1.0 if self._watermark is None else float(decay_scale(new_wm - self._watermark, self.decay_half_life_s))
        weights = np.where(accepted, decay_scale(new_wm - times, self.decay_half_life_s), 0.0).astype(np.float32)
        self._watermark = new_wm
        keep = np.flatnonzero(accepted)
        return _Routing(keep, (np.zeros(keep.size, np.int32),), weights[keep], scale)

    def _scatter(self, args: tuple, kwargs: Dict[str, Any], routing: _Routing) -> None:
        """Add one routed batch into the current slabs, in place: the inner
        update's per-sample deltas in chunks, each chunk added at every
        covering row's slots (decay: weighted into a fresh slab, then added to
        the scaled accumulator)."""
        args = tuple(torch.as_tensor(a, device=self.device) for a in args)
        kwargs = {k: torch.as_tensor(v, device=self.device) for k, v in kwargs.items()}
        data = (*args, *kwargs.values())
        if routing.keep is not None:
            keep = torch.from_numpy(routing.keep).to(self.device)
            data = tuple(a.index_select(0, keep) for a in data)
        n = routing.rows[0].shape[0]
        targets = self._current_state()
        if self.decay:  # the weighted deltas land in a fresh slab, added to the scaled accumulator after
            targets = {name: torch.zeros_like(v) for name, v in targets.items()}
        rows = _DeviceRows(routing.rows, self.device)
        weights = None if routing.weights is None else torch.from_numpy(routing.weights).to(self.device)
        if n:
            kw_keys, n_args = tuple(kwargs), len(args)
            for pos, part in sample_chunks(self.metric, data, np.arange(n)):
                lo, hi = int(pos[0]), int(pos[-1]) + 1
                deltas = per_sample_deltas(self.metric, part, n_args, kw_keys)
                for name in self.metric._defaults:
                    target, leaf = targets[name], deltas[name]
                    if is_sketch(target):
                        target, leaf = target.counts, leaf.counts
                    elif weights is not None:
                        leaf = leaf.to(target.dtype) * weights[lo:hi].reshape((-1,) + (1,) * (leaf.ndim - 1))
                    for local, ids in rows.chunk(lo, hi):
                        self._scatter_row(target, self._slab_reduce[name],
                                          leaf if local is None else leaf.index_select(0, local), ids)
            count = targets[_ROWS_STATE]
            ones = torch.ones(n, dtype=count.dtype, device=self.device) if weights is None else weights
            for local, ids in rows.chunk(0, n):
                self._scatter_row(count, "sum", ones if local is None else ones.index_select(0, local), ids)
        if self.decay:
            self._set_state({name: getattr(self, name) * routing.scale + fresh for name, fresh in targets.items()})

    def _scatter_row(self, target: Tensor, reduce: str, deltas: Tensor, ids: Tensor) -> None:
        """Fold per-sample deltas into ``target`` at ``ids``, in place. The
        decay accumulator's one slot takes every kept sample, so its scatter is
        a sum, taken as ``sum`` (a pairwise reduction on the card, where an
        ``index_add_`` onto one row would round in its atomics' order)."""
        if self.decay:
            target.add_(deltas.sum(0, keepdim=True))
        else:
            scatter_rows_(target, reduce, deltas, ids)

    def _integrity_state(self) -> Dict[str, Any]:
        """The ``check_finite`` view: min / max slabs with their untouched
        windows masked to zero, whose identity fills rest at the dtype
        extremes the saturation scan flags."""
        return _mask_untouched(self._current_state(), self._slab_reduce, _ROWS_STATE)

    def _reset_slots(self, slots: Any) -> None:
        """Return recycled ring slots to their per-slot defaults (the roll)."""
        index = torch.as_tensor(np.asarray(slots, dtype=np.int64)).to(self.device)
        for name, spec in self._defaults.items():
            reset_rows_(getattr(self, name), spec, index)

    # --------------------------------------------------------------- compute
    def compute(self) -> Any:
        """The merged view over every resident window (decay mode: the
        exponentially weighted value). With ``slide_s`` the resident windows
        overlap, so it returns the newest window whose full span has opened,
        ``head - overlap + 1``."""
        if self.slide_s is not None:
            resident = self.resident_windows()
            if resident:
                return self.compute_window(max(self._head - self._spec.overlap + 1, resident[0]))
        state = self._current_state()
        rows = state.pop(_ROWS_STATE)
        inner: State = {}
        for name, value in state.items():
            reduce = self._slab_reduce[name]
            if is_sketch(value):
                merged = type(value)(value.counts.sum(0))
            elif reduce in ("sum", "mean"):
                merged = value.sum(0)
            elif reduce == "min":
                merged = value.amin(0)
            else:
                merged = value.amax(0)
            if reduce == "mean":
                merged = merged / self._mean_denom(rows.sum(), merged.dtype)
            inner[name] = merged
        return self._mask_empty(self.metric.compute_from_state(inner), rows.sum() > 0)

    def _resident_slot(self, window: int) -> int:
        if self.decay:
            raise ValueError("the decay accumulator has no windows; use compute()")
        if window not in self.resident_windows():
            raise KeyError(
                f"window {window} is not resident (resident: {self.resident_windows()}); it expired from the ring"
                " or has not opened yet"
            )
        return window % self.num_windows

    def compute_window(self, window: int) -> Any:
        """One resident window's value; ``window`` is the absolute window index
        (``floor(t / stride)``). Reads the local state (no sync, no cache)."""
        slot = self._resident_slot(window)
        state = self._current_state()
        rows = state.pop(_ROWS_STATE)
        inner: State = {}
        for name, value in state.items():
            row = type(value)(value.counts[slot]) if is_sketch(value) else value[slot]
            if self._slab_reduce[name] == "mean":
                row = row / self._mean_denom(rows[slot], row.dtype)
            inner[name] = row
        return self._mask_empty(self.metric.compute_from_state(inner), rows[slot] > 0)

    # -------------------------------------------------- mergeable partials
    def window_partial(self, window: int) -> Dict[str, Any]:
        """One resident window's raw state rows as a host-transferable,
        mergeable partial: ``{"version", "window", "window_start_s", "rows",
        "state"}``, every leaf host numpy in raw (sum-backed) form, a sketch as
        its sketch type holding numpy counts. The JAX package reads and writes
        the same layout."""
        slot = self._resident_slot(window)
        state = self._current_state()
        rows = state.pop(_ROWS_STATE)
        out: Dict[str, Any] = {}
        for name, value in state.items():
            # host copies: the roll resets a recycled slot in place, and a banked partial must outlive it
            out[name] = type(value)(host_copy(value.counts[slot])) if is_sketch(value) else host_copy(value[slot])
        return {"version": PARTIAL_SCHEMA_VERSION, "window": int(window), "window_start_s": self.window_start(window),
                "rows": host_copy(rows[slot]), "state": out}

    def _empty_partial(self) -> Dict[str, Any]:
        """The identity partial: per-slot defaults and zero rows."""
        state: Dict[str, Any] = {}
        for name, spec in self._defaults.items():
            if name != _ROWS_STATE:
                fresh = slab_init(spec)
                state[name] = type(fresh)(fresh.counts[0].numpy()) if is_sketch(fresh) else fresh[0].numpy()
        return {"version": PARTIAL_SCHEMA_VERSION, "window": -1, "rows": np.zeros((), np.float32), "state": state}

    # the wire-format validator, surfaced here as in the JAX package
    check_partial_version = staticmethod(check_partial_version)

    def merge_partials(self, partials: Any) -> Tuple[State, Tensor]:
        """Merge :meth:`window_partial` outputs (of either package) by their
        reduce kind: ``(inner_state, rows)`` in raw (sum-backed) form, rows as
        float32. Each partial's version is validated first."""
        if not partials:
            partials = [self._empty_partial()]
        acc: State = {}
        rows = torch.zeros((), dtype=torch.float32, device=self.device)
        for partial in partials:
            self.check_partial_version(partial)
            rows = rows + torch.as_tensor(np.asarray(partial["rows"]), device=self.device).to(torch.float32)
            for name, leaf in partial["state"].items():
                live = getattr(self, name)
                if is_sketch(live):
                    counts = torch.as_tensor(np.asarray(leaf.counts), device=self.device).to(live.counts.dtype)
                    acc[name] = type(live)(counts if name not in acc else acc[name].counts + counts)
                else:
                    value = torch.as_tensor(np.asarray(leaf), device=self.device).to(live.dtype)
                    acc[name] = value if name not in acc else slab_merge(self._slab_reduce[name], acc[name], value)
        return acc, rows

    def value_from_partials(self, partials: Any) -> Any:
        """The finished value over merged partials: merge, divide the
        sum-backed means by the merged count, run the inner finisher and apply
        the ``empty`` policy."""
        merged, rows = self.merge_partials(partials)
        inner: State = {}
        for name, value in merged.items():
            if self._slab_reduce[name] == "mean" and not is_sketch(value):
                value = value / self._mean_denom(rows, value.dtype)
            inner[name] = value
        return self._mask_empty(self.metric.compute_from_state(inner), rows > 0)

    @staticmethod
    def _mean_denom(rows: Tensor, dtype: torch.dtype) -> Tensor:
        """Sum-backed mean divisor: the (decayed) sample count, 1 where empty (masked after)."""
        rows = rows.to(dtype)
        return torch.where(rows > 0, rows, torch.ones((), dtype=dtype, device=rows.device))

    def _mask_empty(self, result: Any, occupied: Tensor) -> Any:
        def mask(r: Tensor) -> Tensor:
            fill = float("nan") if self.empty == "nan" and (r.is_floating_point() or r.is_complex()) else 0
            return torch.where(occupied, r, torch.full((), fill, dtype=r.dtype, device=r.device))

        return _tree_map(mask, result)

    # ------------------------------------------------------------- lifecycle
    # ---------------------------------------------------- sparse delta sync
    def sparse_plane(self, group: Any = None, *, capacity: Optional[int] = None, **kwargs: Any) -> Any:
        """A :class:`~metrics_tpu_torch.parallel.sparse.SparseSyncPlane` over
        the window ring: every leaf is a ``(num_windows, ...)`` slab, so a round
        exchanges the windows a step wrote (the head window, and a late
        event's neighbour), not the whole ring. The capacity defaults to the
        ring (``num_windows``): it never overflows. Ring mode is integer-exact;
        decay mode's float rows add their deltas exactly while the effective
        counts are integer-valued. Build the plane while the metric is reset."""
        from metrics_tpu_torch.parallel.sparse import SparseSyncPlane

        return SparseSyncPlane(self._current_state(), dict(self._reductions), self.num_windows, group,
                               capacity=self.num_windows if capacity is None else capacity, **kwargs)

    def reset(self) -> None:
        super().reset()
        self._watermark = None
        self._head = None
        self._origin = None
        self._dropped = 0
        self._late = 0
        self._agreed_seen = None

    def state_dict(self, destination: Optional[dict] = None, prefix: str = "") -> dict:  # type: ignore[override]
        """Window slabs persist through the base path; the host-side stream
        position (watermark, head, origin, drop and late counters, the agreed
        clock as last seen) rides along, so a restored metric resumes
        mid-window with the same verdicts."""
        destination = super().state_dict(destination, prefix=prefix)
        destination[prefix + "_windowed_watermark"] = np.asarray(
            np.nan if self._watermark is None else self._watermark, dtype=np.float64)
        destination[prefix + "_windowed_head"] = np.asarray(0 if self._head is None else self._head, dtype=np.int64)
        destination[prefix + "_windowed_origin"] = np.asarray(0 if self._origin is None else self._origin,
                                                              dtype=np.int64)
        destination[prefix + "_windowed_dropped"] = np.asarray(self._dropped, dtype=np.int64)
        destination[prefix + "_windowed_late"] = np.asarray(self._late, dtype=np.int64)
        destination[prefix + "_windowed_agreed"] = np.asarray(
            np.nan if self._agreed_seen is None else self._agreed_seen, dtype=np.float64)
        return destination

    def load_state_dict(self, state_dict: dict, prefix: str = "") -> None:  # type: ignore[override]
        super().load_state_dict(state_dict, prefix=prefix)
        key = prefix + "_windowed_watermark"
        if key not in state_dict:
            return
        wm = float(np.asarray(state_dict[key]))
        self._watermark = None if math.isnan(wm) else wm
        head = int(np.asarray(state_dict[prefix + "_windowed_head"]))
        self._head = None if self._watermark is None or self.decay else head
        origin_key = prefix + "_windowed_origin"
        if origin_key in state_dict:
            origin = int(np.asarray(state_dict[origin_key]))
            self._origin = None if self._head is None else origin
        self._dropped = int(np.asarray(state_dict[prefix + "_windowed_dropped"]))
        self._late = int(np.asarray(state_dict[prefix + "_windowed_late"]))
        agreed_key = prefix + "_windowed_agreed"
        if agreed_key in state_dict:
            loaded = float(np.asarray(state_dict[agreed_key]))
            if not math.isnan(loaded) and (self._agreed_seen is None or loaded > self._agreed_seen):
                self._agreed_seen = loaded
        if self._agreement is not None and self._watermark is not None:
            # the restored rank rejoins at its checkpointed clock; reports are
            # monotone per rank, so an old checkpoint cannot pull the min back
            self._agreement.report(self._rank, self._watermark)
            self._refresh_agreed()

    def __deepcopy__(self, memo: dict) -> "Windowed":
        # a deep copy (a shadow twin, a cloned rank) keeps talking to the same
        # agreement: the registry's own __deepcopy__ returns itself
        new = type(self).__new__(type(self))
        memo[id(self)] = new
        new.__setstate__(deepcopy(Metric.__getstate__(self), memo))
        return new

    def __getstate__(self) -> dict:
        # the agreement is a live process-wide registry that never pickles; a
        # restored metric re-attaches with attach_agreement
        state = super().__getstate__()
        state.pop("_agreement", None)
        return state

    def __setstate__(self, state: dict) -> None:
        super().__setstate__(state)
        self.__dict__.setdefault("_agreement", None)
        self.__dict__.setdefault("_rank", None)
        self.__dict__.setdefault("_agreed_seen", None)
        self.__dict__.setdefault("slide_s", None)

    def __repr__(self) -> str:
        if self.decay:
            return f"Windowed({self.metric!r}, decay_half_life_s={self.decay_half_life_s})"
        slide = "" if self.slide_s is None else f" slide_s={self.slide_s},"
        return (f"Windowed({self.metric!r}, window_s={self.window_s},{slide} num_windows={self.num_windows},"
                f" allowed_lateness_s={self.allowed_lateness_s})")


class _DeviceRows:
    """A routed batch's slot-id rows on the device, copied once: for a range
    of samples, each row's ``(local positions or None, slot ids)``, where the
    positions pick the samples whose id in that row is not ``-1`` (``None``:
    all of them)."""

    def __init__(self, rows: Tuple[np.ndarray, ...], device: torch.device):
        self._pos, parts = [], []
        for row in rows:
            pos = np.flatnonzero(row >= 0)
            self._pos.append(None if pos.size == row.size else pos)
            parts.append(row.astype(np.int64) if pos.size == row.size else np.stack([pos, row[pos]]).reshape(-1))
        flat = torch.from_numpy(np.concatenate(parts) if parts else np.zeros(0, np.int64)).to(device)
        self._dev, offset = [], 0
        for pos, part in zip(self._pos, parts):
            n = part.size if pos is None else pos.size
            self._dev.append(flat[offset: offset + part.size].view(-1) if pos is None
                             else flat[offset: offset + part.size].view(2, n))
            offset += part.size

    def chunk(self, lo: int, hi: int):
        """``(local positions or None, slot ids)`` of each row over samples ``[lo, hi)``."""
        out = []
        for pos, dev in zip(self._pos, self._dev):
            if pos is None:
                out.append((None, dev[lo:hi]))
                continue
            a, b = np.searchsorted(pos, [lo, hi])
            if b > a:
                out.append((dev[0, a:b] - lo, dev[1, a:b]))
        return out
