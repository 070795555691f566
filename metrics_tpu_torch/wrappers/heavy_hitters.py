"""HeavyHitters: open-world key cardinality; an exact hot slab over a certified count-min tail.

Counterpart of ``metrics_tpu/wrappers/heavy_hitters.py``. ``Keyed(metric,
num_slots)`` caps the segment space at ``num_slots`` and LRU eviction destroys
an evicted tenant's history. ``HeavyHitters`` keeps two tiers, both ordinary
mergeable states:

- **Hot tier**: the top-K keys own exact ``(K, *shape)`` slab rows (the
  ``SlabSpec`` machinery): bit-exact per-key values.
- **Tail tier**: every other key folds its per-sample delta into a
  :class:`~metrics_tpu_torch.parallel.cms.CountMinSketch` per inner state,
  ``(depth, width, *shape)``: constant memory in the live key count, reads
  certified as overcounts by at most ``(e / width) * N`` samples with
  probability ``1 - e^-depth``.
- **Promotion / demotion**: a host-side Space-Saving table
  (:class:`SpaceSavingTable`) moves keys as traffic shifts; a demoted key's
  slab rows are folded into the tail before its slot resets, so hot + tail
  totals are the whole stream's bit for bit.

Both tiers are sum-reduced, so the sync rides the existing sum buckets: the
collective count is the unkeyed metric's at any key count. Key resolution is
host work by construction; the table's decisions are the JAX package's, key
for key. Each sample's delta is computed once (``torch.func.vmap``, in chunks,
as in ``Keyed``) and added in place into the tier its key was routed to: the
hot samples with one ``index_add_`` into the slab, the tail samples with one
``index_add_`` per count-min row.

Not ported yet: ``sparse_plane`` (it needs ``parallel/sparse.py``).
"""
import functools
import math
from typing import Any, Callable, Dict, Hashable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric, State
from metrics_tpu_torch.observability.counters import COUNTERS as _COUNTERS, record_heavy_hitters
from metrics_tpu_torch.parallel.cms import (
    CMSSpec,
    CMSTail,
    CountMinSketch,
    cms_buckets,
    cms_error_bound,
    cms_row_state,
    cms_total,
    make_cms_spec,
    stable_key_hash_array,
    stable_key_hashes,
)
from metrics_tpu_torch.parallel.qsketch import QSketchSpec, QuantileSketch
from metrics_tpu_torch.parallel.sketch import SketchSpec, is_sketch, sketch_init
from metrics_tpu_torch.parallel.slab import scatter_rows_, slab_rows_spec, slab_take_rows
from metrics_tpu_torch.utils.data import accum_int_dtype
from metrics_tpu_torch.wrappers.keyed import (
    _tree_map,
    mask_empty,
    per_sample_deltas,
    reset_rows_,
    routed_forward,
    sample_chunks,
    slab_spec_for,
    vmapped_finish,
)

__all__ = ["HeavyHitters", "SpaceSavingTable"]

# the hot tier's per-slot sample-count slab and the tail tier's sample-count
# sketch: occupancy masks, the sum-backed mean division, the certificate's N
_ROWS_STATE = "hh_rows"
_TAIL_ROWS_STATE = "hh_tail_rows"
_TAIL_SUFFIX = "_tail"

_EMPTY_POLICIES = ("nan", "zero")


def _key_hashes(keys: Sequence[Hashable]) -> np.ndarray:
    """The key hash of record of each key: the vectorized form over a batch of
    one key type (int, str or bytes), the scalar form otherwise (both are
    bit-equal to ``stable_key_hash``)."""
    kinds = {type(k) for k in keys}
    if len(kinds) == 1 and kinds <= {int, str, bytes}:
        return stable_key_hash_array(np.asarray(keys))
    return stable_key_hashes(keys)


class SpaceSavingTable:
    """Host-side Space-Saving key -> slot table over an open key space.

    Maps the estimated-heaviest ``num_slots`` keys onto exact slab rows and
    routes everyone else to the count-min tail. Per hot key it tracks ``hot``
    (exact samples scattered into the key's row since admission) and
    ``credit`` (the key's tail estimate at admission, Space-Saving's carried
    overestimate; that mass stays in the tail). A non-resident key whose
    estimate exceeds the smallest hot count takes that key's slot, and the
    demoted key's exact mass is folded back into the tail. A host mirror of
    the tail's sample-count sketch serves the promotion decisions and gauges
    with no device read, and rides checkpoints.
    """

    def __init__(self, num_slots: int, depth: int, width: int, seed: int):
        if not isinstance(num_slots, int) or num_slots < 1:
            raise ValueError(f"`num_slots` must be a positive int, got {num_slots!r}")
        self.num_slots = num_slots
        self.depth, self.width, self.seed = depth, width, seed
        self._map: Dict[Hashable, int] = {}
        self._free: List[int] = list(range(num_slots - 1, -1, -1))  # pop() ascends
        self._hot: Dict[Hashable, int] = {}
        self._credit: Dict[Hashable, int] = {}
        self._residue: Dict[Hashable, bool] = {}
        self._mirror = np.zeros((depth, width), dtype=np.int64)
        self.promotions = 0
        self.demotions = 0

    def __len__(self) -> int:
        return len(self._map)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._map

    def keys(self) -> Tuple[Hashable, ...]:
        """Current hot keys (insertion order; ranking is by count)."""
        return tuple(self._map)

    def slot_of(self, key: Hashable) -> int:
        if key not in self._map:
            raise KeyError(
                f"key {key!r} is not hot-resident; {len(self._map)}/{self.num_slots}"
                " slots occupied (tail keys read through tail_estimate)"
            )
        return self._map[key]

    def count_of(self, key: Hashable) -> int:
        """The Space-Saving count: exact hot samples + admission credit."""
        return self._hot[key] + self._credit[key]

    def hot_samples_of(self, key: Hashable) -> int:
        return self._hot[key]

    def is_exact(self, key: Hashable) -> bool:
        """Whether the key's slab row holds its whole history: admitted with
        zero estimated tail mass and never demoted since."""
        return not self._residue[key]

    def buckets_for(self, keys: Sequence[Hashable]) -> np.ndarray:
        """``(N, depth)`` tail buckets for a batch of keys (the seeded
        multiply-shift family over the key hash of record)."""
        return cms_buckets(_key_hashes(keys), self.depth, self.width, self.seed)

    def _estimate(self, buckets: np.ndarray) -> int:
        return int(self._mirror[np.arange(self.depth), buckets].min())

    def tail_estimate(self, key: Hashable) -> int:
        """Mirror count-min read: a certified overcount of the key's tail mass."""
        return self._estimate(self.buckets_for([key])[0])

    def tail_mass(self) -> int:
        """Total tail samples (every insert lands in every row: row 0's sum)."""
        return int(self._mirror[0].sum())

    def resolve(self, keys: Sequence[Hashable]) -> Tuple[np.ndarray, List[Tuple[Hashable, int]], np.ndarray]:
        """Route one batch: ``(slot_ids int32 (N,), demoted, buckets (N, depth))``.

        ``slot_ids[i]`` is the sample's hot slot, or ``-1`` for the tail;
        ``buckets`` its tail buckets. ``demoted`` lists ``(key, slot)`` pairs
        whose rows the caller folds into the tail before resetting the slots
        and scattering the batch. Decisions are per distinct key in
        first-appearance order, and a key already routed or admitted this batch
        is never a demotion victim, so no sample of the batch is split across
        the tiers. The decisions equal the JAX package's table key for key: a
        key is promoted only when its estimate exceeds the smallest count of an
        untouched hot key, and that smallest count is at least the smallest
        hot count overall, so a key whose estimate does not exceed the latter
        goes to the tail without the scan.
        """
        distinct: Dict[Hashable, int] = {}
        for key in keys:
            distinct[key] = distinct.get(key, 0) + 1
        order = list(distinct)
        key_buckets = self.buckets_for(order)  # (D, depth), one hash per distinct key
        rows = np.arange(self.depth)

        decisions: Dict[Hashable, int] = {}
        touched: set = set()
        demoted: List[Tuple[Hashable, int]] = []
        floor: Optional[int] = None  # the smallest hot count; None = to recompute
        for i, key in enumerate(order):
            cnt = distinct[key]
            if key in self._map:
                slot = self._map[key]
                touched.add(key)
            elif self._free:
                slot = self._free.pop()
                self._admit(key, slot, key_buckets[i])
                touched.add(key)
                floor = None
            else:
                est = self._estimate(key_buckets[i]) + cnt
                if floor is None:
                    floor = min(self._hot[k] + self._credit[k] for k in self._map)
                slot = -1  # tail-routed: constant memory, certified read
                if est > floor:
                    victim, victim_count = None, None
                    for k in self._map:
                        if k in touched:
                            continue
                        c = self._hot[k] + self._credit[k]
                        if victim_count is None or c < victim_count:
                            victim, victim_count = k, c
                    if victim is not None and est > victim_count:
                        slot = self._demote(victim)
                        demoted.append((victim, slot))
                        self._admit(key, slot, key_buckets[i])
                        touched.add(key)
                        floor = None
            decisions[key] = slot

        slot_of = np.fromiter((decisions[k] for k in order), dtype=np.int32, count=len(order))
        position = {k: i for i, k in enumerate(order)}
        inverse = np.fromiter((position[k] for k in keys), dtype=np.int64, count=len(keys))
        counts = np.fromiter((distinct[k] for k in order), dtype=np.int64, count=len(order))
        for key, slot, cnt in zip(order, slot_of, counts):
            if slot >= 0:
                self._hot[key] += int(cnt)
        tail = slot_of < 0
        np.add.at(self._mirror, (rows[None, :], key_buckets[tail]), counts[tail, None])
        return slot_of[inverse], demoted, key_buckets[inverse]

    def _admit(self, key: Hashable, slot: int, buckets: np.ndarray) -> None:
        credit = self._estimate(buckets)
        self._map[key] = slot
        self._hot[key] = 0
        self._credit[key] = credit
        # nonzero credit: the key's earlier mass stays in the tail, so its row
        # is exact since promotion only
        self._residue[key] = credit > 0
        self.promotions += 1

    def _demote(self, key: Hashable) -> int:
        slot = self._map.pop(key)
        # the key's exact hot mass returns to the tail (the caller folds the
        # device rows; the mirror follows the sample counts)
        self._mirror[np.arange(self.depth), self.buckets_for([key])[0]] += self._hot.pop(key)
        self._credit.pop(key)
        self._residue.pop(key)
        self.demotions += 1
        return slot

    def state(self) -> dict:
        """Checkpointable view (keys, per-key bookkeeping, the mirror)."""
        keys = list(self._map)
        return {
            "keys": keys,
            "slots": np.asarray([self._map[k] for k in keys], dtype=np.int64),
            "hot": np.asarray([self._hot[k] for k in keys], dtype=np.int64),
            "credit": np.asarray([self._credit[k] for k in keys], dtype=np.int64),
            "residue": np.asarray([self._residue[k] for k in keys], dtype=np.bool_),
            "mirror": self._mirror.copy(),
            "promotions": np.asarray(self.promotions, dtype=np.int64),
            "demotions": np.asarray(self.demotions, dtype=np.int64),
        }

    def load_state(self, state: dict) -> None:
        keys = list(state["keys"])
        self._map = {k: int(s) for k, s in zip(keys, np.asarray(state["slots"]))}
        self._hot = {k: int(v) for k, v in zip(keys, np.asarray(state["hot"]))}
        self._credit = {k: int(v) for k, v in zip(keys, np.asarray(state["credit"]))}
        self._residue = {k: bool(v) for k, v in zip(keys, np.asarray(state["residue"]))}
        used = set(self._map.values())
        self._free = [s for s in range(self.num_slots - 1, -1, -1) if s not in used]
        self._mirror = np.asarray(state["mirror"], dtype=np.int64).copy()
        self.promotions = int(state["promotions"])
        self.demotions = int(state["demotions"])

    def reset(self) -> None:
        """Forget every key and the mirror (the epoch reset). The lifetime
        promotion / demotion counts are process gauges and survive."""
        self._map.clear()
        self._hot.clear()
        self._credit.clear()
        self._residue.clear()
        self._free = list(range(self.num_slots - 1, -1, -1))
        self._mirror[:] = 0


def _tail_add_(counts: Tensor, buckets: Tensor, deltas: Tensor) -> None:
    """Add ``(n, *item)`` deltas into ``(depth, width, *item)`` count-min
    counts in place at each sample's ``(n, depth)`` buckets (all in range):
    one ``index_add_`` per row."""
    depth, width = counts.shape[0], counts.shape[1]
    flat = counts.view(depth * width, *counts.shape[2:])
    deltas = deltas.to(counts.dtype)
    for d in range(depth):
        flat.index_add_(0, buckets[:, d] + d * width, deltas)


class HeavyHitters(Metric):
    r"""Two-tier open-world fan-out of ``metric``: exact top-K slab rows over
    a certified count-min tail.

    Args:
        metric: the inner metric. Its states become ``(K, *shape)`` hot slabs
            plus ``(depth, width, *shape)`` count-min tails. States must be
            ``sum`` / ``mean`` tensors or sketch states with non-negative
            per-sample deltas (the tail's certified-overcount contract);
            ``min`` / ``max`` states (use ``Keyed``) and cat / buffer states
            (use ``approx="sketch"``) are rejected.
        num_hot_slots: K, the exact hot rows.
        tail: the count-min grid: a ``CMSTail``, a ``(depth, width)`` pair or a
            bare width.
        empty: what reads report where nothing is resident: ``"nan"`` (default;
            non-float results fall back to 0) or ``"zero"``.

    ``update(*data, key=keys)`` takes one hashable key per sample (str, bytes
    or int). ``compute()`` returns the hot tier's ``(K,)`` values;
    ``compute(key=k)`` reads one key from whichever tier holds it (hot: its
    exact row; tail: the certified overcount estimate, :meth:`tail_estimate`);
    :meth:`compute_heavy_hitters` returns the current top-K with their
    guarantee flags.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy
        >>> hh = HeavyHitters(Accuracy(device="cpu"), num_hot_slots=2, tail=(4, 64))
        >>> preds = torch.tensor([0.9, 0.8, 0.3, 0.1])
        >>> target = torch.tensor([1, 0, 0, 0])
        >>> hh.update(preds, target, key=["a", "b", "b", "a"])
        >>> [r["key"] for r in hh.compute_heavy_hitters()]
        ['a', 'b']
    """

    def __init__(
        self,
        metric: Metric,
        num_hot_slots: int,
        tail: Any = CMSTail(),
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
        self.num_hot_slots = int(num_hot_slots)
        rows_spec = make_cms_spec(tail, (), accum_int_dtype())
        self.tail = CMSTail(rows_spec.depth, rows_spec.width, rows_spec.seed)
        self.empty = empty
        self._metric_label = f"HeavyHitters({type(metric).__name__})"

        if not metric._defaults:
            raise ValueError("the inner metric declares no states; nothing to key")
        reserved = {_ROWS_STATE, _TAIL_ROWS_STATE} | {name + _TAIL_SUFFIX for name in metric._defaults}
        if reserved & set(metric._defaults):
            raise ValueError(
                f"the inner metric's state names collide with the wrapper's ({sorted(reserved & set(metric._defaults))})"
            )
        self._slab_reduce: Dict[str, str] = {}
        for name in metric._defaults:
            slab = slab_spec_for(metric, name, self.num_hot_slots, ("sum", "mean"), "HeavyHitters")
            self._slab_reduce[name] = slab.reduce
            self.add_state(name, default=slab, dist_reduce_fx="sum", persistent=True)
            self.add_state(name + _TAIL_SUFFIX,
                           default=CMSSpec(self.tail.depth, self.tail.width, slab.item_shape, slab.dtype, self.tail.seed),
                           dist_reduce_fx="sum", persistent=True)
        self.add_state(_ROWS_STATE, default=slab_rows_spec(self.num_hot_slots), dist_reduce_fx="sum", persistent=True)
        self.add_state(_TAIL_ROWS_STATE, default=rows_spec, dist_reduce_fx="sum", persistent=True)
        self._table = SpaceSavingTable(self.num_hot_slots, self.tail.depth, self.tail.width, self.tail.seed)

    # ---------------------------------------------------------------- update
    def update(self, *args: Any, key: Any = None, **kwargs: Any) -> None:
        """Route one batch across the tiers.

        ``key`` (required, keyword-only) is one hashable key per sample; every
        data argument shares the leading sample axis with it. Hot keys add into
        their exact rows, tail keys into the count-min tail, and a tail key
        whose estimate overtakes the coldest hot key's count is promoted (the
        demoted key's rows fold into the tail first: mass is conserved).
        """
        self._scatter(args, kwargs, self._route(key))

    def forward(self, *args: Any, key: Any = None, **kwargs: Any) -> Any:
        """The routed forward (:func:`~metrics_tpu_torch.wrappers.keyed.routed_forward`):
        a demotion folds the accumulated rows, and the batch value is the
        batch's own routing over a fresh state."""
        return routed_forward(self, args, kwargs, "key", key)

    def _route(self, key: Any) -> Tuple[np.ndarray, np.ndarray]:
        """One batch's routing through the space-saving table: ``(slot ids,
        tail buckets)`` per sample (host). Demoted keys' current rows fold into
        the tail first; the gauges follow."""
        if key is None:
            raise ValueError("HeavyHitters.update requires `key=` (one key per sample)")
        keys = key.reshape(-1).tolist() if isinstance(key, (Tensor, np.ndarray)) else list(key)
        slot_ids, demoted, buckets = self._table.resolve(keys)
        if demoted:
            self._fold_demoted(demoted)
        self._note_hh_gauges()
        return slot_ids, buckets

    def _scatter(self, args: tuple, kwargs: Dict[str, Any], routing: Tuple[np.ndarray, np.ndarray]) -> None:
        """Add one routed batch into the current tiers, in place: each sample's
        delta once, into its hot row or its tail buckets."""
        slot_ids, buckets = routing
        args = tuple(torch.as_tensor(a, device=self.device) for a in args)
        kwargs = {k: torch.as_tensor(v, device=self.device) for k, v in kwargs.items()}
        data = (*args, *kwargs.values())
        if not data:
            raise ValueError("HeavyHitters.update needs at least one data argument")
        hot = slot_ids >= 0
        kw_keys, n_args = tuple(kwargs), len(args)
        for tier, where in (("hot", np.flatnonzero(hot)), ("tail", np.flatnonzero(~hot))):
            if where.size == 0:
                continue
            sel = torch.from_numpy(where).to(self.device)
            index = torch.from_numpy(slot_ids[where].astype(np.int64) if tier == "hot"
                                     else buckets[where].astype(np.int64)).to(self.device)
            for part_index, part in sample_chunks(self.metric, tuple(a.index_select(0, sel) for a in data), index):
                deltas = per_sample_deltas(self.metric, part, n_args, kw_keys)
                for name in self.metric._defaults:
                    leaf = deltas[name]
                    payload = leaf.counts if is_sketch(leaf) else leaf
                    if tier == "hot":
                        current = getattr(self, name)
                        scatter_rows_(current.counts if is_sketch(current) else current, "sum", payload, part_index)
                    else:
                        _tail_add_(getattr(self, name + _TAIL_SUFFIX).counts, part_index, payload)
            ones = torch.ones(index.shape[0], dtype=accum_int_dtype(), device=self.device)
            if tier == "hot":
                scatter_rows_(getattr(self, _ROWS_STATE), "sum", ones, index)
            else:
                _tail_add_(getattr(self, _TAIL_ROWS_STATE).counts, index, ones)

    def _fold_demoted(self, demoted: List[Tuple[Hashable, int]]) -> None:
        """Fold the demoted keys' exact rows into the tail, then reset their
        slots: the mass-conserving eviction (``Keyed``'s LRU zeroes here)."""
        buckets = torch.from_numpy(self._table.buckets_for([k for k, _ in demoted]).astype(np.int64)).to(self.device)
        slots = [s for _, s in demoted]
        for name in self.metric._defaults:
            _tail_add_(getattr(self, name + _TAIL_SUFFIX).counts, buckets, slab_take_rows(getattr(self, name), slots))
        _tail_add_(getattr(self, _TAIL_ROWS_STATE).counts, buckets, slab_take_rows(getattr(self, _ROWS_STATE), slots))
        # reset the recycled rows (the hot states and the rows slab; the tails
        # just received the folded mass)
        index = torch.as_tensor(np.asarray(slots, dtype=np.int64)).to(self.device)
        for name in (*self.metric._defaults, _ROWS_STATE):
            reset_rows_(getattr(self, name), self._defaults[name], index)

    def _note_hh_gauges(self) -> None:
        """Feed the heavy-hitter gauges while counting is enabled (table
        bookkeeping and the host mirror: no device read)."""
        if not _COUNTERS.enabled:
            return
        mass = self._table.tail_mass()
        record_heavy_hitters(self._metric_label, hot_slots=self.num_hot_slots, hot_occupied=len(self._table),
                             promotions=self._table.promotions, demotions=self._table.demotions,
                             tail_mass=mass, tail_bound=math.e / self.tail.width * mass)

    # --------------------------------------------------------------- compute
    def compute(self) -> Any:
        """The hot tier's K values: the inner finisher vmapped over the hot
        slab (empty slots per the ``empty`` policy). The wrapped form also
        takes ``compute(key=k)`` for one key from whichever tier holds it."""
        state = self._current_state()
        rows = state[_ROWS_STATE]
        inner: State = {}
        for name in self.metric._defaults:
            value = state[name]
            if self._slab_reduce[name] == "mean":
                denom = torch.clamp(rows, min=1).to(value.dtype).reshape((self.num_hot_slots,) + (1,) * (value.ndim - 1))
                value = value / denom
            inner[name] = value
        return mask_empty(vmapped_finish(self.metric, inner, self.num_hot_slots), rows > 0, self.empty)

    def _wrap_compute(self, compute: Callable) -> Callable:
        """The base wrapper (sync and cache) plus the ``key=`` read: hot keys
        slice the cached ``(K, ...)`` results, tail keys read the certified
        count-min estimate from the local state."""
        wrapped = super()._wrap_compute(compute)

        @functools.wraps(compute)
        def with_key(key: Any = None) -> Any:
            out = wrapped()
            if key is None:
                return out
            if key in self._table:
                slot = self._table.slot_of(key)
                return _tree_map(lambda v: v[slot], out)
            return self.tail_estimate(key)["value"]

        return with_key

    def tail_estimate(self, key: Hashable) -> Dict[str, Any]:
        """Certified tail read of one key: ``{"value", "count", "bound",
        "exact": False}``. ``count`` is the count-min sample estimate (at least
        the true count); every state is read from the same argmin row, so the
        estimate is one consistent state; ``bound`` is the ``(e / width) * N``
        overcount certificate. Reads the local state (a point query does not
        sync)."""
        buckets = torch.from_numpy(self._table.buckets_for([key])[0].astype(np.int64)).to(self.device)
        tail_rows = getattr(self, _TAIL_ROWS_STATE).counts
        per_row = cms_row_state(tail_rows, buckets)  # (depth,)
        row = int(torch.argmin(per_row))
        count = int(per_row[row])
        bound = float(cms_error_bound(tail_rows))
        inner: State = {}
        for name, spec in self.metric._defaults.items():
            leaf = cms_row_state(getattr(self, name + _TAIL_SUFFIX).counts, buckets)[row]
            if self._slab_reduce[name] == "mean":
                leaf = leaf / max(count, 1)
            if isinstance(spec, SketchSpec):
                leaf = type(sketch_init(spec))(leaf)
            elif isinstance(spec, QSketchSpec):
                leaf = QuantileSketch(leaf)
            inner[name] = leaf
        result = self.metric.compute_from_state(inner)

        def mask(r: Tensor) -> Tensor:
            if count > 0:
                return r
            if self.empty == "nan" and (r.is_floating_point() or r.is_complex()):
                return torch.full_like(r, float("nan"))
            return torch.zeros_like(r)

        return {"value": _tree_map(mask, result), "count": count, "bound": bound, "exact": False}

    def compute_heavy_hitters(self, k: Optional[int] = None) -> List[Dict[str, Any]]:
        """The current top-K, heaviest first: ``[{"key", "slot", "count",
        "samples", "exact", "value"}, ...]``. ``count`` is the Space-Saving
        count (exact hot samples + the admission credit), ``samples`` the exact
        hot samples, ``exact`` whether the key's row holds its whole history,
        ``value`` the key's slice of ``compute()``."""
        values = self.compute()
        records = []
        for key in self._table.keys():
            slot = self._table.slot_of(key)
            records.append({
                "key": key,
                "slot": slot,
                "count": self._table.count_of(key),
                "samples": self._table.hot_samples_of(key),
                "exact": self._table.is_exact(key),
                "value": _tree_map(lambda v: v[slot], values),
            })
        records.sort(key=lambda r: (-r["count"], str(r["key"])))
        return records[:k] if k is not None else records

    def tail_mass(self) -> int:
        """Total samples resident in the tail (the device state of record)."""
        return int(cms_total(getattr(self, _TAIL_ROWS_STATE).counts))

    def tail_overcount_bound(self) -> float:
        """The tail's current ``(e / width) * N`` certificate, in samples."""
        return float(cms_error_bound(getattr(self, _TAIL_ROWS_STATE).counts))

    # ------------------------------------------------------------- lifecycle
    # ---------------------------------------------------- sparse delta sync
    def sparse_plane(self, group: Any = None, *, capacity: int = 64, **kwargs: Any) -> Any:
        """A :class:`~metrics_tpu_torch.parallel.sparse.SparseSyncPlane` over
        the two-tier state: the hot ``(K, *item)`` slabs and ``hh_rows`` ride
        the row exchange; the count-min tails (``*_tail``, ``hh_tail_rows``)
        are dense residuals whose int64 deltas ride the bitmap collective, so a
        round moves the touched hot rows plus the fixed tail, with no extra
        collective. Every state is sum-reduced, so the split is delta-exact.
        Build the plane while the metric is reset."""
        from metrics_tpu_torch.parallel.sparse import SparseSyncPlane

        state = self._current_state()
        rows = tuple(n for n in state if not (n.endswith(_TAIL_SUFFIX) or n == _TAIL_ROWS_STATE))
        return SparseSyncPlane(state, dict(self._reductions), self.num_hot_slots, group, capacity=capacity,
                               row_leaves=rows, **kwargs)

    def reset(self) -> None:
        super().reset()
        self._table.reset()

    _TABLE_KEY = "_hh_table"

    def state_dict(self, destination: Optional[dict] = None, prefix: str = "") -> dict:  # type: ignore[override]
        """Slab and tail states persist through the base path; the space-saving
        table (key map, counts, credit, residue flags, the host mirror) rides
        along, so a restored metric routes the same keys the same way."""
        destination = super().state_dict(destination, prefix=prefix)
        destination[prefix + self._TABLE_KEY] = self._table.state()
        return destination

    def load_state_dict(self, state_dict: dict, prefix: str = "") -> None:  # type: ignore[override]
        super().load_state_dict(state_dict, prefix=prefix)
        key = prefix + self._TABLE_KEY
        if key in state_dict:
            self._table.load_state(state_dict[key])

    def __repr__(self) -> str:
        return f"HeavyHitters({self.metric!r}, num_hot_slots={self.num_hot_slots}, tail={self.tail})"
