"""Keyed multi-tenant metric slabs: one metric x thousands of segments.

Counterpart of ``metrics_tpu/parallel/slab.py``. Serving rarely wants one
global number; it wants AUROC per model version x cohort x language x A/B arm.
Segments become a leading state axis: a *slab* is a ``(K, *inner_shape)``
state, one row per segment slot, whose per-slot semantics are the inner
metric's ordinary reduce kind:

- ``sum`` / ``mean`` rows accumulate by addition (``mean`` is stored
  sum-backed and divided by the per-slot sample count at compute time);
- ``min`` / ``max`` rows accumulate by elementwise min / max;
- sketch states (histogram, rank, quantile, count-min) keep their own type
  with a leading ``(K, ...)`` counts axis.

An update is one scatter of the inner metric's per-sample deltas
(:func:`slab_scatter`), and the sync rides the existing per-(dtype, op)
buckets of ``parallel/sync.py`` unchanged: a slab is a plain tensor (or
sketch) state with a ``sum`` / ``min`` / ``max`` reduction, so one
``all_reduce`` moves all K segments and the collective count does not depend
on K.

The JAX package scatters with ``jax.ops.segment_sum / min / max``, which drop
an out-of-range slot id by XLA's scatter semantics. A CUDA ``index_add_`` /
``scatter_reduce_`` with such an index is a device-side assert that ends the
process, so every scatter here routes the out-of-range samples to a valid row
with the reduction's identity (zero, or the min / max identity) as their
value: the same result, and no index ever leaves ``[0, K)``.

Left out: ``bucket_size`` / ``pad_samples`` / ``pad_slot_ids`` /
``shared_ingest_program`` / ``SlabProgramCache``. They exist to reuse XLA
compilations across batch sizes, and an eager port compiles nothing.
"""
from collections import OrderedDict
from typing import Any, Hashable, List, NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.parallel.cms import CountMinSketch
from metrics_tpu_torch.parallel.qsketch import QuantileSketch
from metrics_tpu_torch.parallel.sketch import HistogramSketch, RankSketch, is_sketch
from metrics_tpu_torch.utils.data import accum_int_dtype, device_constant

__all__ = [
    "LRUSlotTable",
    "PARTIAL_SCHEMA_VERSION",
    "SLAB_REDUCES",
    "SLAB_SKETCH_KINDS",
    "SlabSpec",
    "check_partial_version",
    "dropped_slot_count",
    "is_slab_spec",
    "make_slab_spec",
    "slab_init",
    "slab_merge",
    "slab_rows_spec",
    "slab_scatter",
    "slab_sync_reduce",
    "slab_take_rows",
    "slab_touched_mask",
]

# The mergeable-partial wire-format version, stamped into every partial the
# wrappers emit (``Keyed.mergeable_partial``) and validated at every ingest
# point. Partials of either package carry the same number: a partial made by
# one package merges in the other.
PARTIAL_SCHEMA_VERSION = 1


def check_partial_version(partial: Any) -> Any:
    """Validate one mergeable partial's wire-format version, loudly: a partial
    without a ``version`` stamp, or with another one, raises ``ValueError``.
    Returns the partial unchanged."""
    if not isinstance(partial, dict) or "state" not in partial or "rows" not in partial:
        raise ValueError(
            "not a mergeable partial (expected a dict with 'version', 'rows'"
            f" and 'state' keys): {type(partial).__name__}"
        )
    version = partial.get("version")
    if version != PARTIAL_SCHEMA_VERSION:
        raise ValueError(
            f"mergeable-partial schema version mismatch: got {version!r},"
            f" this library speaks version {PARTIAL_SCHEMA_VERSION} —"
            " refusing to merge a drifted wire format"
        )
    return partial


# per-slot reduce kinds a slab row supports; "mean" is sum-backed (the slab
# keeps the running sum, the finisher divides by the per-slot row count), so
# it merges by addition and syncs in the sum bucket
SLAB_REDUCES = ("sum", "mean", "min", "max")

_SKETCH_KINDS = {
    "hist": HistogramSketch,
    "rank": RankSketch,
    "qsketch": QuantileSketch,
    "cms": CountMinSketch,
}
SLAB_SKETCH_KINDS = tuple(_SKETCH_KINDS)


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype


class SlabSpec(NamedTuple):
    """Slab state declaration (what ``Metric.add_state`` records).

    ``kind``: ``"array"`` for a plain ``(K, *item_shape)`` slab, or a sketch
    kind (``"hist"``, ``"rank"``, ``"qsketch"``, ``"cms"``) whose counts grow a
    leading K axis. ``reduce`` is the per-slot reduce kind (sketches: always
    ``"sum"``); ``dtype`` a torch dtype. ``fill`` is the inner metric's
    per-slot default (raveled host bytes; ``None``: zeros), broadcast to every
    row at init: ``min`` / ``max`` rows keep the inner default's clamp (min and
    max are idempotent, so folding the default in once per batch changes
    nothing), while ``sum`` / ``mean`` rows need a zero default (the per-sample
    scatter would add a nonzero one once per sample). Pure config and
    fingerprintable, so slab metrics get compute-group keys.
    """

    kind: str
    num_slots: int
    item_shape: Tuple[int, ...]
    dtype: Any
    reduce: str
    fill: Optional[bytes] = None

    @property
    def row_shape(self) -> Tuple[int, ...]:
        return (self.num_slots, *self.item_shape)

    def fill_template(self) -> np.ndarray:
        """The per-slot init template as host numpy."""
        if self.fill is None:
            return np.zeros(self.item_shape, dtype=_np_dtype(self.dtype))
        return np.frombuffer(self.fill, dtype=_np_dtype(self.dtype)).reshape(self.item_shape)


def is_slab_spec(value: Any) -> bool:
    return isinstance(value, SlabSpec)


def make_slab_spec(num_slots: int, template: Union[np.ndarray, Tensor], reduce: str, kind: str = "array") -> SlabSpec:
    """Validate and build one :class:`SlabSpec` from the inner state's default
    (a host array or a tensor, whose dtype the slab keeps). Sum / mean and
    sketch templates must be zero."""
    if kind != "array" and kind not in _SKETCH_KINDS:
        raise ValueError(f"slab kind must be 'array' or one of {SLAB_SKETCH_KINDS}, got {kind!r}")
    if reduce not in SLAB_REDUCES:
        raise ValueError(f"slab reduce must be one of {SLAB_REDUCES}, got {reduce!r}")
    if not isinstance(num_slots, int) or isinstance(num_slots, bool) or num_slots < 1:
        raise ValueError(f"`num_slots` must be a positive int, got {num_slots!r}")
    tensor = torch.as_tensor(template).detach().cpu()
    host = tensor.numpy()
    fill: Optional[bytes] = None
    if reduce in ("sum", "mean") or kind in _SKETCH_KINDS:
        if np.any(host != 0):
            raise ValueError(
                f"a {reduce!r}-kind slab needs a zero default template (the per-sample"
                " scatter would re-add a nonzero default once per sample); got a"
                " nonzero template"
            )
    elif np.any(host != 0):
        fill = np.ascontiguousarray(host).tobytes()
    return SlabSpec(kind, num_slots, tuple(host.shape), tensor.dtype, reduce, fill)


def slab_rows_spec(num_slots: int, dtype: Any = None) -> SlabSpec:
    """The per-slot sample-count slab every ``Keyed`` wrapper carries: a
    ``(K,)`` sum slab backing the occupancy mask (the empty-slot policy) and
    the sum-backed mean division. Rows are ``accum_int_dtype`` (int64)."""
    return SlabSpec("array", num_slots, (), dtype or accum_int_dtype(), "sum", None)


def slab_init(spec: SlabSpec, device: Optional[Union[str, torch.device]] = None) -> Any:
    """Fresh slab for ``spec`` on ``device``: zeros, or the fill template
    broadcast to every row (the template is copied to the device once per
    spec and device, so a reset reads nothing from the host)."""
    if spec.kind in _SKETCH_KINDS:
        return _SKETCH_KINDS[spec.kind](torch.zeros(spec.row_shape, dtype=spec.dtype, device=device))
    if spec.fill is None:
        return torch.zeros(spec.row_shape, dtype=spec.dtype, device=device)
    device = torch.device("cpu") if device is None else torch.device(device)
    template = device_constant(("slab fill", spec.item_shape, str(spec.dtype), spec.fill), device,
                               spec.fill_template, spec.dtype)
    return template.unsqueeze(0).expand(spec.row_shape).clone()


def _identity(reduce: str, dtype: torch.dtype) -> Union[int, float, bool]:
    """The value a sample outside ``[0, K)`` scatters: one that leaves any row as it is."""
    if reduce in ("sum", "mean"):
        return 0
    if dtype == torch.bool:
        return reduce == "min"
    if dtype.is_floating_point:
        return float("inf") if reduce == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if reduce == "min" else info.min


def _routed(slot_ids: Tensor, num_slots: int, device: torch.device) -> Tuple[Tensor, Tensor]:
    """``(index, valid)``: int64 slot ids on ``device`` with every id outside
    ``[0, K)`` routed to row 0, and the flags of the ids that were inside."""
    ids = slot_ids.reshape(-1).to(device=device, dtype=torch.int64)
    valid = (ids >= 0) & (ids < num_slots)
    return torch.where(valid, ids, 0), valid


def scatter_rows_(acc: Tensor, reduce: str, deltas: Tensor, index: Tensor) -> Tensor:
    """Fold ``(N, *item)`` per-sample deltas into the ``(K, *item)`` slab
    ``acc`` in place at ``index`` (int64, every id in ``[0, K)``): an
    ``index_add_`` for sum / mean rows, a ``scatter_reduce_`` with
    ``include_self=True`` for min / max rows, which is a ``segment_min`` /
    ``segment_max`` merged with the accumulator. Returns ``acc``."""
    if reduce in ("sum", "mean"):
        return acc.index_add_(0, index, deltas.to(acc.dtype))
    if reduce not in ("min", "max"):
        raise ValueError(f"slab reduce must be one of {SLAB_REDUCES}, got {reduce!r}")
    full = index.view(-1, *(1,) * (deltas.ndim - 1)).expand(deltas.shape)
    return acc.scatter_reduce_(0, full, deltas.to(acc.dtype), "amin" if reduce == "min" else "amax",
                               include_self=True)


def slab_scatter(reduce: str, deltas: Tensor, slot_ids: Any, num_slots: int) -> Tensor:
    """``(N, *s)`` per-sample deltas -> ``(K, *s)`` per-slot reduction: the
    one-scatter update plane of every slab state.

    ``sum`` / ``mean`` rows scatter-add; ``min`` / ``max`` rows scatter-min /
    max, whose empty rows come back as the reduce identity (``±inf`` /
    ``iinfo`` extremes) and so vanish in the merge with the accumulator.
    Out-of-range slot ids (negative or >= K) are dropped, as the JAX package's
    scatter drops them: those samples scatter the identity at row 0. Out of
    place (``scatter_add`` / ``scatter_reduce``), so it also runs under
    ``torch.func.vmap``, where both have a batching rule."""
    ids = torch.as_tensor(slot_ids)
    index, valid = _routed(ids, num_slots, deltas.device)
    identity = _identity(reduce, deltas.dtype)
    shape = (-1,) + (1,) * (deltas.ndim - 1)
    src = torch.where(valid.view(shape), deltas, torch.full((), identity, dtype=deltas.dtype, device=deltas.device))
    out = torch.full((num_slots, *deltas.shape[1:]), identity, dtype=deltas.dtype, device=deltas.device)
    full = index.view(shape).expand(src.shape)
    if reduce in ("sum", "mean"):
        return out.scatter_add(0, full, src)
    if reduce not in ("min", "max"):
        raise ValueError(f"slab reduce must be one of {SLAB_REDUCES}, got {reduce!r}")
    return out.scatter_reduce(0, full, src, "amin" if reduce == "min" else "amax", include_self=True)


def slab_touched_mask(slot_ids: Any, num_slots: int) -> Tensor:
    """``(K,)`` bool mask of the slab rows a batch's scatter touched; an
    out-of-range id marks no row, matching the row it never wrote."""
    ids = torch.as_tensor(slot_ids)
    index, valid = _routed(ids, num_slots, ids.device)
    counts = torch.zeros(num_slots, dtype=torch.int64, device=ids.device).index_add_(0, index, valid.to(torch.int64))
    return counts > 0


def dropped_slot_count(slot_ids: Any, num_slots: int) -> int:
    """How many of ``slot_ids`` fall outside ``[0, num_slots)``: the samples
    :func:`slab_scatter` drops. Host-side by design (one read of the id
    vector when it lies on the device): the drop itself leaves no trace on the
    device, so the evidence comes from the ids. Call sites feed
    ``observability.counters.record_slab_dropped``, which records even with
    counting off."""
    if isinstance(slot_ids, Tensor):
        slot_ids = slot_ids.detach().cpu().numpy()
    ids = np.asarray(slot_ids).reshape(-1)
    if ids.size == 0:
        return 0
    return int(((ids < 0) | (ids >= num_slots)).sum())


def slab_take_rows(value: Any, slots: Any) -> Tensor:
    """The stacked ``(len(slots), *item)`` rows of the given slots (a sketch
    slab gives its raw counts rows): the demotion fold's read in
    ``HeavyHitters``, which scatters a demoted key's exact rows into the
    count-min tail before the slot is reset."""
    counts = value.counts if is_sketch(value) else value
    idx = torch.as_tensor(np.asarray(slots, dtype=np.int64)).to(counts.device)
    return counts.index_select(0, idx)


def slab_merge(reduce: str, acc: Tensor, delta: Tensor) -> Tensor:
    """Pairwise slab merge under the per-slot reduce kind (mean is sum-backed,
    so it adds). Identity rows from :func:`slab_scatter` are absorbed:
    ``min(acc, +inf) == acc``."""
    if reduce in ("sum", "mean"):
        return acc + delta
    if reduce == "min":
        return torch.minimum(acc, delta)
    if reduce == "max":
        return torch.maximum(acc, delta)
    raise ValueError(f"slab reduce must be one of {SLAB_REDUCES}, got {reduce!r}")


def slab_sync_reduce(reduce: str) -> str:
    """The ``dist_reduce_fx`` a slab state registers: mean folds into sum
    (sum-backed), min / max pass through, so slab states ride the existing
    sum / min / max buckets with no new collective kind."""
    return "sum" if reduce in ("sum", "mean") else reduce


class LRUSlotTable:
    """Host-side key -> slot map for open-ended segment spaces.

    Maps hashable segment keys (cohorts, experiment arms, model versions) onto
    the fixed ``num_slots`` slab rows. When the table is full the
    least-recently-used key is evicted and its slot recycled; the caller
    resets the recycled rows (``Keyed`` does) and the lifetime ``evictions``
    count feeds the slot gauge. Resolution is host work by construction; the
    scatter that consumes the resolved ids runs on the device.
    """

    def __init__(self, num_slots: int):
        if not isinstance(num_slots, int) or num_slots < 1:
            raise ValueError(f"`num_slots` must be a positive int, got {num_slots!r}")
        self.num_slots = num_slots
        self._map: "OrderedDict[Hashable, int]" = OrderedDict()  # LRU -> MRU
        self._free: List[int] = list(range(num_slots - 1, -1, -1))  # pop() ascends
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._map)

    def __contains__(self, key: Hashable) -> bool:
        return key in self._map

    def keys(self) -> Tuple[Hashable, ...]:
        """Current keys, least- to most-recently-used."""
        return tuple(self._map)

    def slot_of(self, key: Hashable) -> int:
        """Resolve one key without touching recency (reads are not uses)."""
        if key not in self._map:
            raise KeyError(
                f"segment key {key!r} is not resident (evicted or never seen); "
                f"{len(self._map)}/{self.num_slots} slots occupied"
            )
        return self._map[key]

    def resolve(self, keys: Sequence[Hashable]) -> Tuple[np.ndarray, List[int]]:
        """Map a batch of keys to slot ids, evicting LRU keys as needed.

        Returns ``(slot_ids int32 (N,), evicted_slots)``: the caller resets the
        evicted slots' rows before scattering. A batch that needs more distinct
        slots than the table holds would recycle a slot this same batch wrote,
        so it raises instead.
        """
        slots = np.empty(len(keys), dtype=np.int32)
        assigned_this_batch: set = set()
        evicted: List[int] = []
        for i, key in enumerate(keys):
            slot = self._map.pop(key, None)  # pop + reinsert = touch (MRU)
            if slot is None:
                if self._free:
                    slot = self._free.pop()
                else:
                    old_key, slot = next(iter(self._map.items()))
                    if old_key in assigned_this_batch:
                        raise ValueError(
                            f"one batch touches more than num_slots={self.num_slots}"
                            " distinct segment keys; evicting a key written by this"
                            " same batch would corrupt its rows. Raise num_slots or"
                            " split the batch."
                        )
                    del self._map[old_key]
                    evicted.append(slot)
                    self.evictions += 1
            self._map[key] = slot
            assigned_this_batch.add(key)
            slots[i] = slot
        return slots, evicted

    def state(self) -> dict:
        """Checkpointable view: keys in LRU order, their slots, evictions."""
        return {
            "keys": list(self._map.keys()),
            "slots": np.asarray(list(self._map.values()), dtype=np.int64),
            "evictions": np.asarray(self.evictions, dtype=np.int64),
        }

    def load_state(self, state: dict) -> None:
        self._map = OrderedDict((key, int(slot)) for key, slot in zip(state["keys"], np.asarray(state["slots"])))
        used = set(self._map.values())
        self._free = [s for s in range(self.num_slots - 1, -1, -1) if s not in used]
        self.evictions = int(state["evictions"])

    def reset(self) -> None:
        """Forget every key (the epoch reset). The lifetime eviction count is
        kept: it is a process gauge, not epoch state."""
        self._map.clear()
        self._free = list(range(self.num_slots - 1, -1, -1))
