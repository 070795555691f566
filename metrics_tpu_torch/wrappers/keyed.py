"""Keyed: one metric x thousands of segments, no new collectives.

Counterpart of ``metrics_tpu/wrappers/keyed.py``. ``Keyed(metric, num_slots)``
turns a per-sample-decomposable metric into a multi-tenant slab metric: every
registered state of the inner metric becomes a ``(K, *shape)`` slab (one row
per segment slot, ``parallel/slab.py``), ``update(..., slot=segment_ids)``
routes each sample's contribution to its segment's row with one scatter,
``compute()`` runs the inner finisher over the slab under ``torch.func.vmap``
and returns all K values at once, and the sync rides the existing
per-(dtype, op) ``all_reduce`` buckets unchanged: the collective count is the
same at K = 1 and K = 10,000.

The per-sample deltas are the inner metric's own ``update`` on size-1
batches under ``torch.func.vmap`` (the JAX package's ``jax.vmap``). Materialized
whole, the deltas of a batch of 65,536 against a ``(2, 2048)`` int64 sketch
would be a 2.1 GiB temporary, so the samples go through in chunks whose
deltas stay under :data:`DELTA_CHUNK_BYTES`, and each chunk is added into the
slab in place (``index_add_``, or ``scatter_reduce_`` for min / max rows):
integer counts are the same in any order, so they equal the JAX package's
bit for bit. The finisher walks the slots in chunks of
:data:`FINISH_CHUNK_BYTES` of state, one vmapped call a chunk. Value checks of
the inner update are skipped under ``vmap``, as the JAX package skips them
under ``jax.vmap``.

Out-of-range slot ids are dropped: the ids are read to the host once an update
(as the JAX package does, to count them), and the samples outside ``[0, K)``
are left out before the scatter, so no index leaves the slab (a CUDA scatter
with one would end the process).

Under ``torch.func.vmap`` (the per-sample deltas of ``Windowed(Keyed(...))``)
the slot ids are batched and cannot be read: the update then reads nothing,
and scatters out of place through :func:`~metrics_tpu_torch.parallel.slab.
slab_scatter`, which writes an out-of-range id's sample as the reduce identity
at a valid row and has a batching rule (a ``scatter_add`` /
``scatter_reduce``, never a per-sample ``index_add``). The caller counts the
dropped ids from its own host copy, as ``Windowed`` does. ``lru=True`` cannot
resolve batched keys and raises ``TracingUnsupportedError``.

Contract on the inner metric: every state is a fixed-shape tensor with a
``sum`` / ``mean`` / ``min`` / ``max`` reduction or a sketch state, and the
inner ``update`` is per-sample decomposable (a batch's update equals the merge
of its samples' updates). Sum / mean defaults must be zero.

Not ported yet: ``sparse_plane`` (it needs ``parallel/sparse.py``) and
``_integrity_state`` (it needs ``check_finite``).
"""
import functools
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor
from torch.func import vmap

from metrics_tpu_torch.core.metric import Metric, State, _BufferSpec
from metrics_tpu_torch.observability.counters import (
    COUNTERS as _COUNTERS,
    record_evicted_mass,
    record_slab_dropped,
    record_slab_slots,
)
from metrics_tpu_torch.parallel.cms import CMSSpec
from metrics_tpu_torch.parallel.qsketch import QSketchSpec
from metrics_tpu_torch.parallel.sketch import SketchSpec, is_sketch
from metrics_tpu_torch.parallel.slab import (
    LRUSlotTable,
    PARTIAL_SCHEMA_VERSION,
    SlabSpec,
    check_partial_version,
    make_slab_spec,
    scatter_rows_,
    slab_init,
    slab_merge,
    slab_rows_spec,
    slab_scatter,
    slab_sync_reduce,
)
from metrics_tpu_torch.utils.data import host_copy, is_batched
from metrics_tpu_torch.utils.device import check_same_device
from metrics_tpu_torch.utils.exceptions import TracingUnsupportedError
from metrics_tpu_torch.utils.prints import rank_zero_warn_once

__all__ = ["Keyed"]

# the per-slot sample-count state every Keyed wrapper carries: occupancy
# masks (the empty-slot policy), the sum-backed mean division, the gauges
_ROWS_STATE = "keyed_rows"

_EMPTY_POLICIES = ("nan", "zero")

# A chunk of samples is sized so that twice its inputs and per-sample deltas
# (the vmapped update's temporaries) stay within this many bytes.
DELTA_CHUNK_BYTES = 256 << 20
# The finisher takes this many bytes of slab state per vmapped call: its
# float64 curve math makes a dozen temporaries of that size.
FINISH_CHUNK_BYTES = 16 << 20


# ------------------------------------------------------------ shared helpers
def _tree_map(fn: Callable, tree: Any) -> Any:
    """``fn`` over the tensors of a value: a tensor, a (named) tuple, a list or a dict."""
    if isinstance(tree, Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def _tree_cat(parts: List[Any]) -> Any:
    """Concatenate a list of equally structured values along dim 0."""
    first = parts[0]
    if len(parts) == 1:
        return first
    if isinstance(first, Tensor):
        return torch.cat(parts)
    if isinstance(first, dict):
        return {k: _tree_cat([p[k] for p in parts]) for k in first}
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_tree_cat([p[i] for p in parts]) for i in range(len(first))))
    return type(first)(_tree_cat([p[i] for p in parts]) for i in range(len(first)))


def _nbytes(state: State) -> int:
    """Bytes of a state dict of tensors and sketches."""
    tensors = [v.counts if is_sketch(v) else v for v in state.values()]
    return sum(t.numel() * t.element_size() for t in tensors)


def _spec_bytes(spec: Any) -> int:
    """Bytes of one sample's delta of an inner state declared by ``spec`` (a
    nested slab's delta is its whole ``(K, *item)`` slab)."""
    if isinstance(spec, (SketchSpec, QSketchSpec, CMSSpec, SlabSpec)):
        shape = spec.row_shape if isinstance(spec, SlabSpec) else spec.shape
        return int(np.prod(shape)) * torch.empty((), dtype=spec.dtype).element_size()
    return spec.numel() * spec.element_size()


def sample_chunks(metric: Metric, data: Sequence[Tensor], index: Tensor) -> Iterator[Tuple[Tensor, tuple]]:
    """``(index chunk, data chunk)`` pairs over the samples of ``data``, each
    chunk small enough that its inputs and per-sample deltas (twice over, for
    the update's temporaries) stay within :data:`DELTA_CHUNK_BYTES`."""
    n = index.shape[0]
    per_sample = sum(_spec_bytes(spec) for spec in metric._defaults.values())
    per_sample += sum(a[:1].numel() * a.element_size() for a in data)
    step = max(1, DELTA_CHUNK_BYTES // max(2 * per_sample, 1))
    for lo in range(0, n, step):
        yield index[lo: lo + step], tuple(a[lo: lo + step] for a in data)


def per_sample_deltas(metric: Metric, data: tuple, n_args: int, kw_keys: tuple) -> State:
    """The inner metric's update of each sample on its own, stacked:
    ``{name: (n, *shape)}`` (a sketch with ``(n, ...)`` counts), computed with
    one ``torch.func.vmap`` over size-1 batches."""

    def one(*sample: Tensor) -> State:
        batch = tuple(a.unsqueeze(0) for a in sample)
        return metric.update_state(metric.init_state(), *batch[:n_args], **dict(zip(kw_keys, batch[n_args:])))

    return vmap(one)(*data)


def vmapped_finish(metric: Metric, state: State, num_slots: int) -> Any:
    """The inner finisher over ``(K, ...)`` slab rows: ``compute_from_state``
    under ``torch.func.vmap``, one call per chunk of :data:`FINISH_CHUNK_BYTES`
    of state, the chunks' results concatenated."""
    per_slot = max(_nbytes(state) // max(num_slots, 1), 1)
    step = max(1, FINISH_CHUNK_BYTES // per_slot)
    compute = vmap(metric.compute_from_state)
    parts = [compute(_tree_map(lambda v, lo=lo: v[lo: lo + step], state)) for lo in range(0, num_slots, step)]
    return _tree_cat(parts)


def mask_empty(results: Any, occupied: Tensor, empty: str) -> Any:
    """Empty slots per the ``empty`` policy: NaN for float results under
    ``"nan"``, else zero."""

    def mask(r: Tensor) -> Tensor:
        occ = occupied.reshape((occupied.shape[0],) + (1,) * (r.ndim - 1))
        if empty == "nan" and (r.is_floating_point() or r.is_complex()):
            return torch.where(occ, r, torch.full((), float("nan"), dtype=r.dtype, device=r.device))
        return torch.where(occ, r, torch.zeros((), dtype=r.dtype, device=r.device))

    return _tree_map(mask, results)


def reset_rows_(value: Any, spec: SlabSpec, index: Tensor) -> None:
    """Return the slab rows at ``index`` to their per-slot default, in place."""
    counts = value.counts if is_sketch(value) else value
    if spec.fill is None:
        counts.index_fill_(0, index, 0)
    else:
        fresh = slab_init(spec, counts.device)
        counts.index_copy_(0, index, fresh.index_select(0, index))


def slab_spec_for(metric: Metric, name: str, num_slots: int, allowed: Tuple[str, ...], who: str) -> SlabSpec:
    """The ``SlabSpec`` one inner state maps onto (reductions in ``allowed``),
    or a loud rejection."""
    spec, fx = metric._defaults[name], metric._reductions[name]
    if isinstance(spec, (SketchSpec, QSketchSpec)):
        # a sketch slabs as a sketch: its counts grow a leading K axis
        kind = "qsketch" if isinstance(spec, QSketchSpec) else spec.kind
        return make_slab_spec(num_slots, torch.zeros(spec.shape, dtype=spec.dtype), "sum", kind=kind)
    if isinstance(spec, (list, _BufferSpec)) or fx == "cat" or fx is None:
        raise ValueError(
            f"state {name!r} of {type(metric).__name__} is a cat/list/buffer state with no per-slot slab form;"
            f" {who} supports fixed-shape {'/'.join(allowed)} states and sketch states (curve/rank metrics:"
            " construct the inner metric with approx='sketch')"
        )
    if not isinstance(spec, Tensor):
        raise ValueError(f"state {name!r} has an unsupported default kind for {who}: {type(spec).__name__}")
    if not (isinstance(fx, str) and fx in allowed):
        raise ValueError(
            f"state {name!r} uses dist_reduce_fx={fx!r}; {who} supports {'/'.join(repr(a) for a in allowed)}"
            " tensor states and sketch states"
        )
    return make_slab_spec(num_slots, spec, fx)


def _mask_untouched(state: Dict[str, Any], slab_reduce: Dict[str, str], rows_state: str) -> Dict[str, Any]:
    """``state`` with every min / max slab's rows that never took a sample set
    to zero (the integrity scan's view of a slab state)."""
    occupied = state[rows_state] > 0
    out = {}
    for name, value in state.items():
        if slab_reduce.get(name) in ("min", "max") and not is_sketch(value):
            occ = occupied.reshape(occupied.shape + (1,) * (value.ndim - occupied.ndim))
            value = torch.where(occ, value, torch.zeros((), dtype=value.dtype, device=value.device))
        out[name] = value
    return out


def routed_forward(metric: Metric, args: tuple, kwargs: Dict[str, Any], key_name: str, key: Any) -> Any:
    """The forward of a wrapper whose host table routes each batch
    (``Keyed(lru=True)``, ``HeavyHitters``): the batch is routed once, against
    the accumulator, so an eviction or a demotion acts on the accumulated rows,
    and the batch value is the same routing scattered into a fresh state.

    The one-delta forward would route against the fresh delta: a recycled row
    would keep the evicted key's history in the accumulator (the JAX package's
    fused forward does so; ROADMAP section 3)."""
    metric._computed = None
    metric._forward_cache = None
    check_same_device(metric.device, *args, *kwargs.values(), key)
    metric._note_rows(args, {**kwargs, key_name: key})
    revert_to = metric._pre_update_snapshot()
    routing = metric._route(key)
    metric._scatter(args, kwargs, routing)
    metric._guard_state_integrity("forward", revert_to)
    if not metric.compute_on_step:
        return None
    saved = metric._current_state()
    metric._set_state(metric.init_state())
    try:
        metric._scatter(args, kwargs, routing)
        batch = metric._current_state()
    finally:
        metric._set_state(saved)
    metric._forward_cache = metric._compute_on(batch, sync=metric.dist_sync_on_step)
    return metric._forward_cache


# ------------------------------------------------------------------- wrapper
class Keyed(Metric):
    r"""Per-segment fan-out of ``metric`` over ``num_slots`` slab rows.

    Args:
        metric: the inner metric. Its states become ``(K, *shape)`` slabs; its
            ``update`` / ``compute`` are reused as the per-sample delta and the
            per-slot finisher. The instance itself never accumulates.
        num_slots: K, the number of segment rows.
        lru: accept hashable segment keys in ``update(..., slot=keys)`` and map
            them onto the K rows with an :class:`LRUSlotTable`
            (least-recently-used eviction; evicted rows reset and their lost
            samples are counted in ``evicted_mass_dropped``). With
            ``lru=False`` (default) ``slot`` is an int array of slot ids in
            ``[0, K)``; out-of-range ids are dropped and counted, never
            misrouted.
        empty: what ``compute()`` reports for never-updated slots: ``"nan"``
            (default; non-float results fall back to 0) or ``"zero"``.

    ``compute()`` returns the inner result with a leading ``(K,)`` axis;
    ``compute(slot=k)`` reads one segment (in LRU mode ``k`` is the key). The
    sync (``dist_sync_on_step``, ``compute()`` in a process group,
    ``pure().sync``) rides the base machinery: slab states are ordinary sum /
    min / max tensor (or sketch) states, so the whole wrapper syncs through
    the same buckets as the unkeyed metric. An update adds into the slab in
    place, so a state dict handed to ``update_state`` is consumed.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy
        >>> acc = Keyed(Accuracy(device="cpu"), num_slots=3)
        >>> preds = torch.tensor([0.9, 0.8, 0.3, 0.1])
        >>> target = torch.tensor([1, 0, 0, 0])
        >>> acc.update(preds, target, slot=torch.tensor([0, 1, 1, 0]))
        >>> [round(float(v), 2) for v in acc.compute()[:2]]
        [1.0, 0.5]
    """

    def __init__(
        self,
        metric: Metric,
        num_slots: int,
        lru: bool = False,
        empty: str = "nan",
        compute_on_step: Optional[bool] = None,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
    ):
        if not isinstance(metric, Metric):
            raise ValueError(f"`metric` must be a Metric, got {type(metric).__name__}")
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
        self.num_slots = int(num_slots)
        self.lru = bool(lru)
        self.empty = empty
        self._metric_label = f"Keyed({type(metric).__name__})"
        self._slots = LRUSlotTable(self.num_slots) if lru else None
        self._occupied_host: set = set()  # gauge bookkeeping, not state

        if not metric._defaults:
            raise ValueError("the inner metric declares no states; nothing to key")
        if _ROWS_STATE in metric._defaults:
            raise ValueError(f"the inner metric already has a state named {_ROWS_STATE!r}")
        self._slab_reduce: Dict[str, str] = {}
        for name in metric._defaults:
            slab = slab_spec_for(metric, name, self.num_slots, ("sum", "mean", "min", "max"), "Keyed")
            self._slab_reduce[name] = slab.reduce
            self.add_state(name, default=slab, dist_reduce_fx=slab_sync_reduce(slab.reduce), persistent=True)
        self.add_state(_ROWS_STATE, default=slab_rows_spec(self.num_slots), dist_reduce_fx="sum", persistent=True)

    # ---------------------------------------------------------------- update
    def update(self, *args: Any, slot: Any = None, **kwargs: Any) -> None:
        """Scatter one batch into the segment slabs.

        ``slot`` (required, keyword-only) is one segment id per sample: an int
        array or tensor with ids in ``[0, num_slots)``, or with ``lru=True`` a
        sequence of hashable keys. Every data argument shares the leading sample
        axis with ``slot``.
        """
        self._scatter(args, kwargs, self._route(slot))

    def forward(self, *args: Any, slot: Any = None, **kwargs: Any) -> Any:
        """The one-delta forward; with ``lru=True`` the routed forward
        (:func:`routed_forward`), so that an eviction resets the accumulated row."""
        if not self.lru:
            return super().forward(*args, slot=slot, **kwargs)
        return routed_forward(self, args, kwargs, "slot", slot)

    def _route(self, slot: Any) -> Tuple[Tensor, Optional[Tensor]]:
        """One batch's routing: ``(slot ids on the device, the index of the
        samples kept or None)``. Resolves LRU keys (an eviction resets the
        current rows), counts and leaves out the out-of-range ids, and feeds
        the slot gauges."""
        if slot is None:
            raise ValueError("Keyed.update requires `slot=` (one segment id per sample)")
        if is_batched(slot):
            # under vmap: nothing can be read back, so nothing is counted here
            # and the scatter drops the out-of-range ids itself (_scatter_batched)
            if self.lru:
                raise TracingUnsupportedError(
                    "Keyed(lru=True) resolves segment keys on the host and cannot run under torch.func.vmap;"
                    " drive it eagerly, or use lru=False with integer slot ids"
                )
            return slot.reshape(-1).to(torch.int64), None
        ids_host, ids = self._resolve_slot_ids(slot)
        keep = None
        if not self.lru:
            # out-of-range ids leave no trace on the device: count them from the
            # host copy of the ids (recorded even with counting off), and leave
            # their samples out of the scatter
            inside = (ids_host >= 0) & (ids_host < self.num_slots)
            dropped = int(ids_host.shape[0] - np.count_nonzero(inside))
            if dropped:
                record_slab_dropped(dropped)
                keep = torch.from_numpy(np.flatnonzero(inside)).to(self.device)
                ids = ids.index_select(0, keep)
        self._note_slab_gauges(ids_host)
        return ids, keep

    def _scatter(self, args: tuple, kwargs: Dict[str, Any], routing: Tuple[Tensor, Optional[Tensor]]) -> None:
        """Add one routed batch into the current slabs, in place."""
        ids, keep = routing
        args = tuple(torch.as_tensor(a, device=self.device) for a in args)
        kwargs = {k: torch.as_tensor(v, device=self.device) for k, v in kwargs.items()}
        data = (*args, *kwargs.values())
        if not data:
            raise ValueError("Keyed.update needs at least one data argument")
        if keep is not None:
            data = tuple(a.index_select(0, keep) for a in data)
        kw_keys, n_args = tuple(kwargs), len(args)
        if is_batched(ids):
            self._scatter_batched(data, n_args, kw_keys, ids)
            return
        for part_ids, part in sample_chunks(self.metric, data, ids):
            deltas = per_sample_deltas(self.metric, part, n_args, kw_keys)
            for name in self.metric._defaults:
                current, leaf = getattr(self, name), deltas[name]
                if is_sketch(current):
                    scatter_rows_(current.counts, "sum", leaf.counts, part_ids)
                else:
                    scatter_rows_(current, self._slab_reduce[name], leaf, part_ids)
        rows = getattr(self, _ROWS_STATE)
        rows.index_add_(0, ids, torch.ones(ids.shape, dtype=rows.dtype, device=rows.device))

    def _scatter_batched(self, data: tuple, n_args: int, kw_keys: tuple, ids: Tensor) -> None:
        """The scatter under ``torch.func.vmap``: out of place, through
        :func:`slab_scatter` (out-of-range ids scatter the identity), merged
        into the current slabs. The states are rebound, not written in place:
        an in-place write of a batched delta into an unbatched slab is not
        defined under ``vmap``."""
        deltas = per_sample_deltas(self.metric, data, n_args, kw_keys)
        for name in self.metric._defaults:
            current, leaf = getattr(self, name), deltas[name]
            if is_sketch(current):
                setattr(self, name, type(current)(current.counts + slab_scatter("sum", leaf.counts, ids, self.num_slots)))
            else:
                reduce = self._slab_reduce[name]
                setattr(self, name, slab_merge(reduce, current, slab_scatter(reduce, leaf, ids, self.num_slots)))
        rows = getattr(self, _ROWS_STATE)
        ones = torch.ones(ids.shape, dtype=rows.dtype, device=rows.device)
        setattr(self, _ROWS_STATE, rows + slab_scatter("sum", ones, ids, self.num_slots))

    def _resolve_slot_ids(self, slot: Any) -> Tuple[np.ndarray, Tensor]:
        """``(host ids, device ids)`` of one batch (int64). A tensor of ids is
        read to the host once; host ids are copied to the device once."""
        if self.lru:
            keys = slot.reshape(-1).tolist() if isinstance(slot, (Tensor, np.ndarray)) else list(slot)
            slot_ids, evicted = self._slots.resolve(keys)
            host = slot_ids.astype(np.int64)
            if evicted:
                index = torch.as_tensor(np.asarray(evicted, dtype=np.int64)).to(self.device)
                # an LRU eviction destroys the recycled rows' history: count the
                # mass about to be zeroed, and name the lossless alternative
                mass = int(getattr(self, _ROWS_STATE).index_select(0, index).sum())
                if mass:
                    record_evicted_mass(mass)
                    rank_zero_warn_once(
                        "Keyed(lru=True) evicted a resident segment and zeroed its accumulated history"
                        " (evicted_mass_dropped counts the lost samples). If tenants must never lose mass,"
                        " use HeavyHitters(metric, num_hot_slots, tail=...): demotion folds the evicted row"
                        " into a count-min tail instead of destroying it."
                    )
                self._reset_slots(index)
            return host, torch.from_numpy(host).to(self.device)
        if isinstance(slot, Tensor):
            ids = slot.reshape(-1).to(torch.int64)
            return ids.cpu().numpy(), ids.to(self.device)
        host = np.asarray(slot).reshape(-1).astype(np.int64)
        return host, torch.from_numpy(host).to(self.device)

    def _integrity_state(self) -> Dict[str, Any]:
        """The ``check_finite`` view: min / max slabs with their untouched slots
        masked to zero, whose identity fills rest at the dtype extremes the
        saturation scan flags."""
        return _mask_untouched(self._current_state(), self._slab_reduce, _ROWS_STATE)

    def _reset_slots(self, index: Tensor) -> None:
        """Return recycled rows to their per-slot defaults (the eviction path)."""
        for name, spec in self._defaults.items():
            reset_rows_(getattr(self, name), spec, index)
        self._occupied_host.difference_update(index.tolist())

    def _note_slab_gauges(self, ids_host: np.ndarray) -> None:
        """Feed the slot occupancy / eviction gauge while counting is enabled
        (from the host ids the update already holds: no device read)."""
        if self.lru:
            occupied, evictions = len(self._slots), self._slots.evictions
        elif _COUNTERS.enabled:
            ids = np.unique(ids_host)
            self._occupied_host.update(int(s) for s in ids[(ids >= 0) & (ids < self.num_slots)])
            occupied, evictions = len(self._occupied_host), 0
        else:
            return
        record_slab_slots(self._metric_label, self.num_slots, occupied, evictions)

    # --------------------------------------------------------------- compute
    def compute(self) -> Any:
        """All K per-segment values: the inner finisher vmapped over the slab
        (empty slots per the ``empty`` policy). The wrapped form also takes
        ``compute(slot=k)`` for one segment."""
        state = self._current_state()
        rows = state.pop(_ROWS_STATE)
        return self._finish_slab(state, rows)

    def _finish_slab(self, state: State, rows: Tensor) -> Any:
        """The per-slot finisher: the sum-backed mean division, the vmapped
        inner compute and the empty-slot mask (``compute`` over the live slab,
        :meth:`value_from_partials` over a merged one)."""
        inner: State = {}
        for name, value in state.items():
            if self._slab_reduce[name] == "mean":
                denom = torch.clamp(rows, min=1).to(value.dtype).reshape((self.num_slots,) + (1,) * (value.ndim - 1))
                value = value / denom
            inner[name] = value
        return mask_empty(vmapped_finish(self.metric, inner, self.num_slots), rows > 0, self.empty)

    # -------------------------------------------------- mergeable partials
    def mergeable_partial(self) -> Dict[str, Any]:
        """The whole slab state as a host-transferable, mergeable partial:
        ``{"version", "rows", "state"}``, every leaf host numpy in raw
        (sum-backed) form, a sketch leaf as its sketch type holding numpy
        counts. Partials of shards that share one slot layout merge through
        :meth:`value_from_partials`, bit-exact against one process over all the
        traffic; the JAX package reads and writes the same layout. LRU mode is
        excluded: two LRU tables map keys to rows independently."""
        if self.lru:
            raise ValueError(
                "Keyed(lru=True) slabs are not mergeable across processes: each LRU table maps keys to rows"
                " independently, so two slabs' rows need not describe the same segment — use lru=False with"
                " stable slot ids"
            )
        state = self._current_state()
        rows = state.pop(_ROWS_STATE)
        out: Dict[str, Any] = {}
        for name, value in state.items():
            out[name] = type(value)(host_copy(value.counts)) if is_sketch(value) else host_copy(value)
        return {"version": PARTIAL_SCHEMA_VERSION, "rows": host_copy(rows), "state": out}

    def value_from_partials(self, partials: Sequence[Dict[str, Any]]) -> Any:
        """All K per-segment values over merged partials (addition, min or max
        per the reduce kind, then the finisher). Each partial's wire-format
        version is validated first. A sketch leaf is any tuple with a
        ``counts`` field, so partials of the JAX package merge here too."""
        acc: State = {}
        rows = torch.zeros((self.num_slots,), dtype=getattr(self, _ROWS_STATE).dtype, device=self.device)
        for partial in partials:
            check_partial_version(partial)
            rows = rows + torch.as_tensor(np.asarray(partial["rows"]), device=self.device).to(rows.dtype)
            for name, leaf in partial["state"].items():
                live = getattr(self, name)
                if is_sketch(live):
                    counts = torch.as_tensor(np.asarray(leaf.counts), device=self.device).to(live.counts.dtype)
                    acc[name] = type(live)(counts if name not in acc else acc[name].counts + counts)
                else:
                    value = torch.as_tensor(np.asarray(leaf), device=self.device).to(live.dtype)
                    acc[name] = value if name not in acc else slab_merge(self._slab_reduce[name], acc[name], value)
        for name, spec in self._defaults.items():  # no partials: every slot empty
            if name != _ROWS_STATE and name not in acc:
                acc[name] = slab_init(spec, self.device)
        return self._finish_slab(acc, rows)

    def _wrap_compute(self, compute: Callable) -> Callable:
        """The base wrapper (sync and cache) plus the ``slot=`` read. The cache
        holds the full ``(K, ...)`` results; a slot read slices them."""
        wrapped = super()._wrap_compute(compute)

        @functools.wraps(compute)
        def with_slot(slot: Any = None) -> Any:
            out = wrapped()
            if slot is None:
                return out
            if self.lru:
                slot = self._slots.slot_of(slot)
            return _tree_map(lambda v: v[slot], out)

        return with_slot

    # ------------------------------------------------------------- lifecycle
    # ---------------------------------------------------- sparse delta sync
    def sparse_plane(self, group: Any = None, *, capacity: int = 64, **kwargs: Any) -> Any:
        """A :class:`~metrics_tpu_torch.parallel.sparse.SparseSyncPlane` over
        this wrapper's slab state: a cross-rank sync whose collective bytes
        follow the rows a round touched, not K. Every leaf is a ``(K, *item)``
        slab (the rows slab too), so all of them ride the row exchange; the
        merged view a round returns is a state for ``compute_from_state``.
        Build the plane while the metric is reset, and pass
        :func:`~metrics_tpu_torch.parallel.slab.slab_touched_mask` over a
        step's slot ids as ``touched=`` to skip the full-slab compare."""
        from metrics_tpu_torch.parallel.sparse import SparseSyncPlane

        return SparseSyncPlane(self._current_state(), dict(self._reductions), self.num_slots, group,
                               capacity=capacity, **kwargs)

    def reset(self) -> None:
        super().reset()
        if self._slots is not None:
            self._slots.reset()
        self._occupied_host = set()

    _SLOT_TABLE_KEY = "_keyed_slot_table"

    def state_dict(self, destination: Optional[dict] = None, prefix: str = "") -> dict:  # type: ignore[override]
        """Slab states persist through the base path (tensors, sketch counts);
        the LRU key -> slot map rides along, so a restored metric resolves the
        same keys to the same rows."""
        destination = super().state_dict(destination, prefix=prefix)
        if self._slots is not None:
            destination[prefix + self._SLOT_TABLE_KEY] = self._slots.state()
        return destination

    def load_state_dict(self, state_dict: dict, prefix: str = "") -> None:  # type: ignore[override]
        super().load_state_dict(state_dict, prefix=prefix)
        key = prefix + self._SLOT_TABLE_KEY
        if self._slots is not None and key in state_dict:
            self._slots.load_state(state_dict[key])

    def __repr__(self) -> str:
        return f"Keyed({self.metric!r}, num_slots={self.num_slots}, lru={self.lru})"
