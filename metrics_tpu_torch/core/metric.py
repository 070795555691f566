"""Core metric runtime: a stateful ``nn.Module`` whose states are registered tensors.

Counterpart of ``metrics_tpu/core/metric.py`` (``Metric``). What carries over:

* ``add_state`` with the sum / mean / min / max / cat / callable reductions;
* the one-delta ``forward``: the batch is run through ``update`` on a fresh
  state (the delta), the delta is merged into the accumulator with the same
  per-state reduction that syncs ranks (``sum`` / ``min`` / ``max``, a list,
  or a callable marked ``associative``), and the batch value is computed from
  the delta. With ``dist_sync_on_step`` the delta is synced first. States
  whose reduction has no pairwise merge take the reference double-update path;
* the wrapped ``compute``: cached value, sync at compute (whenever a
  ``torch.distributed`` group is initialized or a ``dist_sync_fn`` is given),
  and the local state restored after a synced compute;
* ``capacity``: cat states become fixed-capacity
  :class:`~metrics_tpu_torch.parallel.buffer.PaddedBuffer` s, declared with an
  ``item_shape`` or promoted at the first append from the batch's item shape
  and dtype;
* the mergeable sketch states: ``add_state`` takes a ``SketchSpec``,
  ``QSketchSpec`` or ``CMSSpec`` (``dist_reduce_fx="sum"``) and the state is a
  NamedTuple holding one int64 ``counts`` tensor (``metric.hist.counts``),
  materialized at every reset, moved by ``.to()``, merged by addition and
  synced in the sum bucket;
* the keyed slab: ``add_state`` takes a ``SlabSpec`` (``dist_reduce_fx`` its
  ``slab_sync_reduce``), a ``(K, *item)`` tensor or a sketch with a leading K
  axis, merged and synced in the sum / min / max buckets like any state;
* the pure view: ``pure()`` returns a :class:`PureMetric` of ``init_state`` /
  ``update_state`` / ``compute_from_state`` / ``merge_states`` /
  ``sync_state``, functions of an explicit state dict that leave the metric's
  own state as it is;
* ``forward_batched``: a stack of batches (leading step axis) as one call,
  the per-step batch values stacked and the epoch value cached. The JAX
  package runs it as one ``lax.scan`` / ``vmap`` program; here it is an eager
  loop of ``forward`` calls with the same per-step values;
* the integrity guard: :func:`nonfinite_count`, :func:`saturated_count`,
  :func:`state_integrity_counts`, and ``check_finite`` (``"warn"`` /
  ``"raise"`` / ``"quarantine"``) after every update, forward and sync. The
  quarantine restores a copy of the state taken before the update (the port's
  updates write in place, so a reference would not do);
* preemption-safe replay: ``epoch_watermark`` and ``guarded_update(step,
  ..., span_end=)``;
* the deferred per-step sync: ``sync_lag=k`` (or ``"auto"``, with a
  :class:`~metrics_tpu_torch.parallel.deferred.LagController`) keeps a ring of
  ``k`` in-flight :class:`~metrics_tpu_torch.parallel.deferred.SyncHandle` s
  and reads each step's synced value ``k`` steps late; the epoch ``compute()``
  drains the ring first. Handles never travel through ``reset``, ``clone``,
  pickle or deepcopy. ``sync_state(state, group, deferred=True)`` returns a
  handle;
* ``astype`` and ``state_pytree``;
* placement: ``device_put`` takes a ``torch.device`` or a placement policy of
  ``parallel/placement.py`` (``row_sharded``, ``class_sharded``), remembers
  it, and applies it again to every fresh state (``reset``, the forward delta,
  the pure ``init``) and to a buffer promoted at its first append. A metric
  whose ``compute()`` runs a sharded engine over its row-sharded states
  (``_states_own_sync``) skips the gather; a ``class_sharded`` metric syncs
  its class blocks over dp and reassembles them over mp;
* ``reset``, and ``state_dict`` / ``load_state_dict`` in the JAX package's key
  layout (host numpy values, a buffer as ``{"data", "count"}``, a sketch as
  ``{"sketch_counts"}``, plus ``_count_bound`` and ``_epoch_watermark``), so a
  checkpoint of either package loads into the other;
* the compute-group fingerprint ``_group_fingerprint``, in both forms: the
  update attributes a class lists, or every config attribute but the
  compute-only ones it lists;
* metric arithmetic: every operator overload builds a
  :class:`CompositionalMetric`.

PyTorch runs eagerly, so there is no jit and no scan here, and the pure
view's functions run eagerly too.
States live on ``self.device``: ``cuda`` unless the caller passes
``device="cpu"`` (see ``utils/device.py``). Count states are int64.
"""
import functools
import inspect
import time
from abc import ABC, abstractmethod
from collections import deque
from copy import deepcopy
from typing import Any, Callable, Dict, NamedTuple, Optional, Union

import numpy as np
import torch
from torch import Tensor, nn

from metrics_tpu_torch.observability.counters import COUNTERS as _COUNTERS
from metrics_tpu_torch.observability.counters import (
    record_collective,
    record_deferred_depth,
    record_fault,
    record_state_bytes,
    state_nbytes,
)
from metrics_tpu_torch.observability.devtime import DEVTIME as _DEVTIME
from metrics_tpu_torch.observability.devtime import fence as _fence
from metrics_tpu_torch.observability.trace import TRACE
from metrics_tpu_torch.observability.trace import span as _span
from metrics_tpu_torch.parallel.buffer import PaddedBuffer, buffer_append, buffer_init
from metrics_tpu_torch.parallel.cms import CMSSpec, cms_init
from metrics_tpu_torch.parallel.placement import MeshHierarchy
from metrics_tpu_torch.parallel.qsketch import QSketchSpec, qsketch_init
from metrics_tpu_torch.parallel.sketch import SketchSpec, is_sketch, sketch_init
from metrics_tpu_torch.parallel.slab import SlabSpec, slab_init, slab_sync_reduce
from metrics_tpu_torch.parallel.sync import (
    ReduceFx,
    all_reduce_state,
    canonicalize_reduce_fx,
    dist_active,
    host_gather,
    is_mergeable,
    merge_values,
)
from metrics_tpu_torch.utils import debug
from metrics_tpu_torch.utils.data import host_copy, tree_stack
from metrics_tpu_torch.utils.device import check_same_device, resolve_device
from metrics_tpu_torch.utils.exceptions import StateCorruptionError
from metrics_tpu_torch.utils.prints import rank_zero_warn

State = Dict[str, Any]

# attributes holding the bound update/compute wrappers: rebuilt, never copied
_WRAPPER_ATTRS = ("update", "compute", "_update_impl", "_compute_impl")
# live futures and machine-local measurements: they never travel through a
# pickle, a deepcopy or a clone (a copy starts with no in-flight sync)
_LIVE_ATTRS = ("_handle_ring", "_lag_controller")

# instance attributes that are no update config: ``nn.Module``'s own, the
# wrappers, caches, counters and sync settings, and the state registries
# (the group key's schema covers those)
_NON_CONFIG_ATTRS = frozenset(vars(nn.Module())) | frozenset(_WRAPPER_ATTRS) | frozenset({
    "_update_signature", "_computed", "_forward_cache", "_count_bound", "_epoch_watermark",
    "_to_sync", "_in_forward", "_sync_count", "compute_on_step", "dist_sync_on_step", "process_group",
    "dist_sync_fn", "_defaults", "_persistent", "_reductions", "_cat_layouts", "device",
    "check_finite", "sync_lag", "_handle_ring", "_lag_controller", "_state_dtype", "_placement",
})


# every first-class state declaration kind maps to its materializer here, so
# add_state and the reset path branch on one table
_SPEC_MATERIALIZERS = {
    SketchSpec: sketch_init,
    CMSSpec: cms_init,
    QSketchSpec: qsketch_init,
    SlabSpec: slab_init,
}

# the spec kinds whose states are sum-mergeable by construction (merge is
# elementwise add, sync the sum bucket): add_state requires dist_reduce_fx="sum".
# The keyed slab is materialized but not one: its reduction is the spec's own.
_SUM_MERGEABLE_SPECS = (SketchSpec, CMSSpec, QSketchSpec)
_SPECS = tuple(_SPEC_MATERIALIZERS)


def materialize_state_spec(spec: Any, device: Optional[torch.device] = None) -> Any:
    """A fresh state for a registered spec on ``device``."""
    return _SPEC_MATERIALIZERS[type(spec)](spec, device)


class _BufferSpec(NamedTuple):
    """The layout a cat state's PaddedBuffer is (re)built with at every reset."""

    capacity: int
    item_shape: tuple
    dtype: torch.dtype


class _Unfingerprintable(Exception):
    pass


# ---------------------------------------------------- state-integrity scanning
CHECK_FINITE_POLICIES = (None, "warn", "raise", "quarantine")


def _state_tensors(state: Any) -> list:
    """Every tensor of a state (a dict, a list, a PaddedBuffer, a sketch)."""
    if isinstance(state, Tensor):
        return [state]
    if isinstance(state, dict):
        return [t for v in state.values() for t in _state_tensors(v)]
    if isinstance(state, (list, tuple)):  # a sketch is a NamedTuple of its counts
        return [t for v in state for t in _state_tensors(v)]
    if isinstance(state, PaddedBuffer):
        return [state.data, state.count]
    return []


def _count(tensors: list, hits: list) -> Tensor:
    """The number of set elements over ``hits``, an int64 scalar on the device
    of the state's first tensor (the CPU for an empty state)."""
    total = torch.zeros((), dtype=torch.int64, device=tensors[0].device if tensors else None)
    for hit in hits:
        total = total + hit.sum().to(device=total.device, dtype=torch.int64)
    return total


def nonfinite_count(state: Any) -> Tensor:
    """The number of non-finite (NaN / Inf) elements over every float tensor of
    a state (an int64 scalar tensor on the state's device; nothing is read)."""
    tensors = _state_tensors(state)
    return _count(tensors, [~torch.isfinite(t) for t in tensors if t.is_floating_point() or t.is_complex()])


def saturated_count(state: Any) -> Tensor:
    """The number of integer elements within ``max(iinfo.max // 2048, 1)`` of
    their dtype's range: pre-wraparound corruption of a count state (an int64
    scalar tensor; nothing is read)."""
    tensors, hits = _state_tensors(state), []
    for t in tensors:
        if t.is_floating_point() or t.is_complex() or t.dtype == torch.bool:
            continue
        info = torch.iinfo(t.dtype)
        margin = max(info.max // 2048, 1)
        hits.append((t >= info.max - margin) | (t <= info.min + margin))
    return _count(tensors, hits)


def state_integrity_counts(state: Any) -> tuple:
    """``(nonfinite, saturated)`` element counts: the scan behind ``check_finite``."""
    return nonfinite_count(state), saturated_count(state)


def _validate_sync_lag(value: Any, dist_sync_on_step: bool) -> Any:
    """An int in ``[0, MAX_SYNC_LAG]`` or ``"auto"``; anything else raises."""
    from metrics_tpu_torch.parallel.deferred import MAX_SYNC_LAG

    if value == "auto":
        lag: Any = "auto"
    else:
        if isinstance(value, bool) or not isinstance(value, int):
            raise ValueError(f"`sync_lag` must be an int in [0, {MAX_SYNC_LAG}] or 'auto', got {value!r}")
        if not 0 <= value <= MAX_SYNC_LAG:
            raise ValueError(
                f"`sync_lag` must be in [0, {MAX_SYNC_LAG}] (the handle-ring depth is bounded so the"
                f" rendezvous pool and the background host plane never wedge) or 'auto', got {value!r}"
            )
        lag = int(value)
    if lag and not dist_sync_on_step:
        raise ValueError(f"`sync_lag={lag!r}` defers the per-step sync inside `forward`; it requires"
                         " `dist_sync_on_step=True`")
    return lag


class PureMetric(NamedTuple):
    """The pure view of a metric: functions of an explicit state dict.

    ``init() -> state``, ``update(state, *args, **kwargs) -> state``,
    ``compute(state) -> value``, ``merge(a, b) -> state`` and ``sync(state,
    group=None) -> state`` (the bucketed ``all_reduce`` / gather plane over
    ``group``, default the metric's ``process_group``). None of them reads or
    writes the metric's own state."""

    init: Callable[[], Dict[str, Any]]
    update: Callable[..., Dict[str, Any]]
    compute: Callable[[Dict[str, Any]], Any]
    merge: Callable[[Dict[str, Any], Dict[str, Any]], Dict[str, Any]]
    sync: Callable[..., Dict[str, Any]]


def _fingerprint_value(v: Any) -> Any:
    if v is None or isinstance(v, (bool, int, float, str, bytes)):
        return v
    if isinstance(v, Tensor):
        arr = v.detach().cpu().numpy()
        return ("arr", arr.shape, str(arr.dtype), arr.tobytes())
    # the state specs before the generic tuple arm: a stable tag, and the grid
    # parameters as key material (two states merge soundly only on equal grids)
    if isinstance(v, SketchSpec):
        return ("sketchspec", v.kind, v.shape, str(v.dtype), v.lo, v.hi)
    if isinstance(v, QSketchSpec):
        return ("qsketchspec", v.kind, v.shape, str(v.dtype), v.alpha, v.min_value, v.max_value)
    if isinstance(v, CMSSpec):
        return ("cmsspec", v.depth, v.width, v.item_shape, str(v.dtype), v.seed)
    if isinstance(v, SlabSpec):
        # two slab metrics share a compute-group key only on equal (kind, K, row
        # schema, reduce, fill template)
        return ("slabspec", v.kind, v.num_slots, v.item_shape, str(v.dtype), v.reduce, v.fill)
    if isinstance(v, (list, tuple)):
        return (type(v).__name__, tuple(_fingerprint_value(x) for x in v))
    if isinstance(v, dict):
        return ("dict", tuple((k, _fingerprint_value(x)) for k, x in sorted(v.items())))
    if callable(v) or isinstance(v, type):
        return ("fn", id(v))
    try:
        hash(v)
    except TypeError:
        raise _Unfingerprintable(type(v).__name__) from None
    return ("obj", type(v).__name__, v)


class Metric(nn.Module, ABC):
    """Base class of all metrics: stateful accumulation and cross-rank sync.

    Args:
        compute_on_step: ``forward`` returns the batch value if True.
        dist_sync_on_step: sync the batch delta across ranks inside every ``forward``.
        process_group: the ``torch.distributed`` group the sync runs over
            (``None``: the default world group).
        dist_sync_fn: custom gather ``fn(tensor) -> [tensor per rank]``; when
            given, sync gathers, stacks and reduces through it instead of
            the bucketed ``all_reduce``.
        device: where the states live. ``None`` means ``cuda`` and raises
            when no GPU is present; pass ``"cpu"`` to run on the CPU.
        capacity: fixed capacity for cat (list) states. With it they become
            PaddedBuffers: declared with ``item_shape`` at ``add_state``, or
            promoted at the first append, which fixes the item shape and dtype.
        check_finite: the integrity guard (``None``: off). After every update
            and forward, and after each sync, the state is scanned for
            non-finite floats and near-saturated integer counts
            (:func:`state_integrity_counts`; one scalar read). ``"warn"``
            warns, ``"raise"`` throws ``StateCorruptionError``,
            ``"quarantine"`` restores the state from before the update (the
            batch is dropped, ``quarantined_updates`` counts it) or, after a
            sync, keeps the local state. Library metrics do not forward the
            argument: set the ``check_finite`` attribute after construction.
        sync_lag: the deferred per-step sync of ``dist_sync_on_step`` (``0``:
            synchronous). With ``k`` in ``[1, MAX_SYNC_LAG]`` every forward
            enters its delta's sync without waiting and pushes the handle
            onto a ring; once the ring holds more than ``k`` the oldest
            resolves, and the step returns the value computed from it, which
            is the synchronous plane's value ``k`` steps back. Steps
            ``0 .. k-1`` return the local batch value. The accumulator never
            lags: the epoch ``compute()`` drains the ring in entry order and
            syncs afresh. ``"auto"`` lets a ``LagController`` choose ``k``
            from the measured blocking waits. Library metrics: set the
            ``sync_lag`` attribute after construction.
    """

    # Attr names that feed ``update``; a subclass declares them to opt its
    # instances into MetricCollection compute groups. None means never grouped.
    _GROUP_UPDATE_ATTRS: Optional[tuple] = None

    # The exclusion form of the same opt-in: the attrs that are compute-only.
    # Every other config attribute of the instance is then in the group key,
    # so a subclass that adds update config splits off on its own. The
    # retrieval family declares it on its shared base. ``_GROUP_UPDATE_ATTRS``
    # wins when both are set.
    _GROUP_COMPUTE_ONLY_ATTRS: Optional[tuple] = None

    def __init__(
        self,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
        capacity: Optional[int] = None,
        check_finite: Optional[str] = None,
        sync_lag: Any = 0,
    ):
        super().__init__()
        self.device = resolve_device(device)
        self.capacity = capacity
        self.compute_on_step = compute_on_step
        self.dist_sync_on_step = dist_sync_on_step
        self.process_group = process_group
        self.dist_sync_fn = dist_sync_fn
        if check_finite not in CHECK_FINITE_POLICIES:
            raise ValueError(f"`check_finite` must be one of {CHECK_FINITE_POLICIES}, got {check_finite!r}")
        self.check_finite = check_finite
        self.sync_lag = _validate_sync_lag(sync_lag, dist_sync_on_step)
        self._handle_ring: deque = deque()  # in-flight SyncHandles, oldest first (sync_lag >= 1)
        self._lag_controller = None  # a LagController, built at first use (sync_lag="auto")
        self._state_dtype: Optional[torch.dtype] = None  # the last astype target, re-applied at reset
        self._placement: Any = None  # the last device_put target, applied to every fresh state
        self._to_sync = True
        self._in_forward = False
        self._sync_count = 0  # synced computes entered (the debug sync-count check's sequence number)
        self._computed = None
        self._forward_cache = None
        # host-side bookkeeping persisted by state_dict, as in the JAX package:
        # elements processed this epoch, and batches folded into the accumulator
        self._count_bound = 0
        self._epoch_watermark = 0

        self._defaults: Dict[str, Any] = {}  # tensor templates on self.device, [] or a _BufferSpec
        self._persistent: Dict[str, bool] = {}
        self._reductions: Dict[str, ReduceFx] = {}
        # (dtype, item shape) of each list state, from its declaration or first
        # append: a rank that holds no rows still enters the gather with them
        self._cat_layouts: Dict[str, tuple] = {}
        self._wrap_methods()

    def _wrap_methods(self) -> None:
        self._update_impl = type(self).update.__get__(self)
        self._compute_impl = type(self).compute.__get__(self)
        self._update_signature = inspect.signature(self._update_impl)
        self.update = self._wrap_update(self._update_impl)
        self.compute = self._wrap_compute(self._compute_impl)

    # ------------------------------------------------------------------ state
    def add_state(
        self,
        name: str,
        default: Any,
        dist_reduce_fx: Optional[ReduceFx] = None,
        persistent: bool = False,
        item_shape: Optional[tuple] = None,
        item_dtype: Optional[torch.dtype] = None,
    ) -> None:
        """Register a state: a tensor (fixed-shape state, placed on ``self.device``)
        or an empty list (cat state). A list state may declare ``item_shape`` /
        ``item_dtype`` (default float32): with a ``capacity`` it is then a
        PaddedBuffer from the start, and without one the layout lets a rank
        with no rows enter the cross-rank gather.

        ``default`` may also be a ``SketchSpec`` (histogram / rank sketch), a
        ``QSketchSpec`` (quantile sketch) or a ``CMSSpec`` (count-min): the
        state is then a zero-count sketch of the spec's shape, merged by
        elementwise addition and synced in the sum bucket, so
        ``dist_reduce_fx`` must be ``"sum"``.

        Or a ``SlabSpec`` (the keyed slab, ``parallel/slab.py``): the state is
        a ``(K, *item_shape)`` tensor, or a sketch whose counts grow a leading
        K axis, and ``dist_reduce_fx`` must be the spec's
        ``slab_sync_reduce`` (``sum`` for sum / mean / sketch slabs, ``min`` /
        ``max`` as they are), so merge and sync ride the existing buckets."""
        if isinstance(default, SlabSpec):
            expected = slab_sync_reduce(default.reduce)
            if dist_reduce_fx != expected:
                raise ValueError(
                    f"a {default.reduce!r}-kind slab state syncs through the {expected!r} bucket plane;"
                    f" declare it with dist_reduce_fx={expected!r} (got {dist_reduce_fx!r})"
                )
            self._defaults[name] = default
            self._persistent[name] = persistent
            self._reductions[name] = expected
            value = slab_init(default, self.device)
            if isinstance(value, Tensor):
                self.register_buffer(name, value, persistent=False)  # moved by .to() like any tensor state
            else:
                setattr(self, name, value)
            return
        if isinstance(default, _SUM_MERGEABLE_SPECS):
            if dist_reduce_fx != "sum":
                raise ValueError(
                    f"{type(default).__name__} states are sum-mergeable by construction;"
                    f" declare them with dist_reduce_fx='sum' (got {dist_reduce_fx!r})"
                )
            self._defaults[name] = default
            self._persistent[name] = persistent
            self._reductions[name] = "sum"
            setattr(self, name, materialize_state_spec(default, self.device))
            return
        is_list = isinstance(default, list) and len(default) == 0
        is_arraylike = isinstance(default, (int, float, np.ndarray, Tensor)) and not isinstance(default, bool)
        if not (is_list or is_arraylike):
            raise ValueError("state variable must be a tensor or any empty list (where you can append tensors)")
        self._reductions[name] = canonicalize_reduce_fx(dist_reduce_fx)
        self._persistent[name] = persistent
        if is_list:
            if item_shape is not None:
                self._cat_layouts[name] = (item_dtype or torch.float32, tuple(item_shape))
            if self.capacity is not None and item_shape is not None:
                self._defaults[name] = _BufferSpec(self.capacity, tuple(item_shape), item_dtype or torch.float32)
            else:
                self._defaults[name] = []
            setattr(self, name, self._materialize(self._defaults[name]))
            return
        template = torch.as_tensor(default).to(self.device)
        self._defaults[name] = template
        self.register_buffer(name, template.clone(), persistent=False)

    def _append(self, name: str, value: Tensor) -> None:
        """Append to a cat state: a list, or a PaddedBuffer.

        With a ``capacity``, the first append to an undeclared list state
        promotes it to a PaddedBuffer with the batch's item shape and dtype,
        which every later reset rebuilds.
        """
        current = getattr(self, name)
        if isinstance(current, PaddedBuffer):
            setattr(self, name, buffer_append(current, value))
            return
        rows = torch.atleast_1d(value)
        self._cat_layouts.setdefault(name, (rows.dtype, tuple(rows.shape[1:])))
        if self.capacity is not None and isinstance(self._defaults[name], list) and not current:
            spec = _BufferSpec(self.capacity, tuple(rows.shape[1:]), rows.dtype)
            # a placement may reject the buffer (row_sharded's divisibility): it raises before the
            # spec is committed, so a retried update does not half-promote the cat states
            buf = self._fresh(name, spec)
            self._defaults[name] = spec
            setattr(self, name, buffer_append(buf, rows))
            return
        current.append(value)

    def _materialize(self, default: Any) -> Any:
        if isinstance(default, _SPECS):
            return materialize_state_spec(default, self.device)
        if isinstance(default, _BufferSpec):
            return buffer_init(default.capacity, default.item_shape, default.dtype, device=self.device)
        return default.clone() if isinstance(default, Tensor) else []

    def init_state(self) -> State:
        """Fresh default state dict, on ``self.device``, placed by the remembered placement."""
        return {n: self._fresh(n, d) for n, d in self._defaults.items()}

    def _current_state(self) -> State:
        return {name: getattr(self, name) for name in self._defaults}

    # -------------------------------------------------------------- placement
    def device_put(self, device_or_placement: Any) -> "Metric":
        """Place every state: on a ``torch.device`` (or its name), through
        ``.to()``, or by a placement callable ``(name, value) -> target``
        resolved state by state (``parallel.placement.row_sharded`` /
        ``class_sharded``; a target is ``None`` to keep the state as it is, a
        ``torch.device``, a ``RowBlock`` or a ``ClassBlock``).

        The placement is remembered and applied to every fresh state: at
        ``reset()``, to the forward's delta and the pure ``init``, and to a
        buffer promoted at its first append. Every target is resolved before
        any state changes, so a placement that rejects a state leaves the
        metric as it was."""
        if not callable(device_or_placement):
            self.to(torch.device(device_or_placement))
            self._placement = device_or_placement
            return self
        if getattr(device_or_placement, "kind", None) == "class" and self.dist_sync_fn is not None:
            raise ValueError("class_sharded syncs over its hierarchy's groups; it does not take a `dist_sync_fn`")
        placed = {name: self._placed(name, getattr(self, name), self._defaults[name], device_or_placement)
                  for name in self._defaults}
        self._placement = device_or_placement
        self._set_state(placed)
        self._computed = None
        return self

    def _placed(self, name: str, value: Any, default: Any, placement: Any = None) -> Any:
        """``value`` as ``placement`` (default: the remembered one) places state ``name``."""
        placement = self._placement if placement is None else placement
        if placement is None or not callable(placement):
            return value
        from metrics_tpu_torch.parallel.placement import ClassBlock, RowBlock

        view = value
        if isinstance(value, PaddedBuffer) and isinstance(default, _BufferSpec):
            # the policy sees the global capacity, whatever block the state holds now
            view = PaddedBuffer(torch.empty((default.capacity, *value.data.shape[1:]), dtype=value.data.dtype,
                                            device="meta"), value.count)
        elif isinstance(value, list):
            return value
        target = placement(name, view)
        if target is None or isinstance(target, ClassBlock):
            return value  # replicated, or class-sharded at sync time only
        if isinstance(target, RowBlock):
            local = view.capacity // target.world
            if value.capacity == local:
                return value
            # the rows held so far, as far as the block reaches; ``count`` stays, so rows
            # beyond the block show as an overflow at compute (no host read here)
            block = buffer_init(local, tuple(value.data.shape[1:]), value.data.dtype, device=value.data.device)
            block.data[: min(local, value.capacity)] = value.data[:local]
            return PaddedBuffer(block.data, value.count.clone())
        device = torch.device(target)
        if isinstance(value, PaddedBuffer):
            return PaddedBuffer(value.data.to(device), value.count.to(device))
        if is_sketch(value):
            return type(value)(value.counts.to(device))
        return value.to(device)

    def _fresh(self, name: str, default: Any) -> Any:
        """A fresh state for ``default``, placed: a row-sharded buffer is made
        at its block's capacity directly, never at the global one."""
        if isinstance(default, _BufferSpec) and callable(self._placement):
            from metrics_tpu_torch.parallel.placement import RowBlock

            probe = PaddedBuffer(torch.empty((default.capacity, *default.item_shape), dtype=default.dtype,
                                             device="meta"), torch.zeros((), dtype=torch.int64, device="meta"))
            target = self._placement(name, probe)
            if isinstance(target, RowBlock):
                return buffer_init(default.capacity // target.world, default.item_shape, default.dtype,
                                   device=self.device)
        return self._placed(name, self._materialize(default), default)

    def _states_own_sync(self) -> bool:
        """Whether this compute will run a sharded epoch engine whose
        collectives combine the ranks' states, making the gather redundant.
        The metrics with a sharded dispatch override it with the dispatch's
        own applicability test: a declined dispatch must gather."""
        return False

    def _class_placement(self) -> Any:
        placement = self._placement
        return placement if getattr(placement, "kind", None) == "class" else None

    def _set_state(self, state: State) -> None:
        for name, value in state.items():
            setattr(self, name, value)

    def _run_update_on_state(self, state: State, *args: Any, **kwargs: Any) -> State:
        """Run the subclass ``update`` as a function of ``state``."""
        saved = self._current_state()
        self._set_state(state)
        try:
            self._update_impl(*args, **kwargs)
            return self._current_state()
        finally:
            self._set_state(saved)

    def merge_states(self, a: State, b: State) -> State:
        """Pairwise merge of two state dicts (the one-delta forward's fold)."""
        return {name: merge_values(self._reductions[name], a[name], b[name]) for name in self._defaults}

    # -------------------------------------------------------------- pure view
    def update_state(self, state: State, *args: Any, **kwargs: Any) -> State:
        """Pure update: the state after ``update(*args, **kwargs)`` from ``state``."""
        return self._run_update_on_state(state, *args, **kwargs)

    def compute_from_state(self, state: State) -> Any:
        """Pure compute on an explicit state dict (no sync, no cache)."""
        saved = self._current_state()
        self._set_state(state)
        try:
            return self._compute_impl()
        finally:
            self._set_state(saved)

    def sync_state(self, state: State, group: Optional[Any] = None, deferred: bool = False) -> Any:
        """The cross-rank reduction of ``state`` over ``group`` (default: the
        metric's ``process_group``) through the bucketed plane: one
        ``all_reduce`` per (dtype, op) bucket, one gather for the list, stack
        and buffer states. The metric's own state is left as it is. A
        :class:`~metrics_tpu_torch.parallel.placement.MeshHierarchy` as
        ``group`` stages every collective over its two levels (the
        counterpart of the JAX package's mesh form).

        ``deferred=True`` enters the same collectives without waiting and
        returns a :class:`~metrics_tpu_torch.parallel.deferred.SyncHandle`
        whose ``result()`` is the synced state; the buckets reduce copies, so
        the caller may keep updating ``state`` in place meanwhile."""
        if group is None and self._class_placement() is not None:
            if deferred:
                raise ValueError("a class_sharded state has no deferred sync: call sync_state(state) without"
                                 " `deferred=True`")
            return self._synced_state(state=state)
        group = self.process_group if group is None else group
        if deferred:
            from metrics_tpu_torch.parallel.deferred import deferred_sync_state

            return deferred_sync_state(state, self._reductions, group=group, watermark=self._epoch_watermark,
                                       layouts=self._cat_layouts, device=self.device)
        return all_reduce_state(state, self._reductions, group=group, layouts=self._cat_layouts, device=self.device)

    def pure(self) -> PureMetric:
        """The pure view: ``init`` / ``update`` / ``compute`` / ``merge`` /
        ``sync`` over explicit state dicts."""
        return PureMetric(init=self.init_state, update=self.update_state, compute=self.compute_from_state,
                          merge=self.merge_states, sync=self.sync_state)

    # --------------------------------------------------------------- forward
    @property
    def _fusable(self) -> bool:
        return all(is_mergeable(self._reductions[n], getattr(self, n)) for n in self._defaults)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """Accumulate this batch and (if ``compute_on_step``) return its batch value."""
        if TRACE.enabled:
            with _span("metric.forward", {"metric": type(self).__name__}):
                forward = self._forward_fused if self._fusable else self._forward_reference
                out = forward(*args, **kwargs)
                if _DEVTIME.enabled:  # the phase fence: the forward's device tail lands here
                    _fence((out, self._current_state()))
                return out
        if self._fusable:
            return self._forward_fused(*args, **kwargs)
        return self._forward_reference(*args, **kwargs)

    def _forward_fused(self, *args: Any, **kwargs: Any) -> Any:
        self._computed = None
        self._forward_cache = None
        check_same_device(self.device, *args, *kwargs.values())
        self._note_rows(args, kwargs)
        revert_to = self._pre_update_snapshot()
        if TRACE.enabled:
            with _span("metric.forward_update", {"metric": type(self).__name__}):
                delta = self._run_update_on_state(self.init_state(), *args, **kwargs)
        else:
            delta = self._run_update_on_state(self.init_state(), *args, **kwargs)
        self._set_state(self.merge_states(self._current_state(), delta))
        self._guard_state_integrity("forward", revert_to)
        if not self.compute_on_step:
            return None
        self._forward_cache = self._compute_on(delta, sync=self.dist_sync_on_step)
        return self._forward_cache

    def forward_batched(self, *args: Any, **kwargs: Any) -> Any:
        """Accumulate a whole stack of batches (leading axis = steps); returns
        the per-step batch values stacked, or ``None`` when
        ``compute_on_step=False``.

        The same as one ``forward`` per leading-axis slice, which is what it
        runs. Where the JAX package's scan path applies (positional arguments
        only, no ``dist_sync_on_step``, mergeable states) the epoch value of
        the accumulated state is computed too and cached, so a following
        ``compute()`` dispatches nothing, unless a cross-process sync is
        configured (a ``dist_sync_fn`` or an initialized process group): then
        ``compute()`` syncs as usual."""
        data = (*args, *kwargs.values())
        if not data:
            raise ValueError("forward_batched needs at least one argument with a leading step axis")
        steps = int(data[0].shape[0])
        values = [self.forward(*(a[i] for a in args), **{k: v[i] for k, v in kwargs.items()}) for i in range(steps)]
        if not self.compute_on_step:
            return None
        self._cache_batched_epoch(args, kwargs)
        return tree_stack(values)

    def _cache_batched_epoch(self, args: tuple, kwargs: dict) -> None:
        """Cache the epoch value after a stack of forwards where the JAX
        package's scan path would have computed it: positional arguments only,
        no ``dist_sync_on_step``, mergeable states, and no cross-process sync
        configured that a ``compute()`` would have to run."""
        if (args and not kwargs and self.compute_on_step and not self.dist_sync_on_step and self._fusable
                and self.dist_sync_fn is None and not dist_active()):
            self._computed = self._compute_impl()
            self._after_compute(self._computed)

    def _compute_on(self, state: State, sync: bool) -> Any:
        """The batch value: ``compute`` run on ``state`` (synced across ranks
        first when ``sync``), leaving the accumulator and compute cache as they were."""
        self._to_sync = sync
        self._in_forward = True
        acc = self._current_state()
        self._set_state(state)
        try:
            return self.compute()
        finally:
            self._set_state(acc)
            self._to_sync = True
            self._in_forward = False
            self._computed = None

    def _forward_reference(self, *args: Any, **kwargs: Any) -> Any:
        """Double-update path for states without a pairwise merge."""
        self.update(*args, **kwargs)
        self._forward_cache = None
        if not self.compute_on_step:
            return None
        self._to_sync = self.dist_sync_on_step
        self._in_forward = True
        cache = self._current_state()
        bound, watermark = self._count_bound, self._epoch_watermark
        self._set_state(self.init_state())
        try:
            self.update(*args, **kwargs)
            self._forward_cache = self.compute()
        finally:
            self._set_state(cache)
            self._count_bound, self._epoch_watermark = bound, watermark
            self._to_sync = True
            self._in_forward = False
        self._computed = None
        return self._forward_cache

    def _note_rows(self, args: tuple, kwargs: dict) -> None:
        # min over argument sizes ~ the number of labeled samples; every
        # accumulation path notes its rows once per logical step, which is
        # also where the epoch watermark advances
        sizes = [a.numel() for a in (*args, *kwargs.values()) if isinstance(a, Tensor)]
        if sizes:
            self._count_bound += min(sizes)
        if not self._in_forward:
            self._epoch_watermark += 1

    def note_count(self, amount: int) -> None:
        """Advance the host-side count bound by ``amount``, as the JAX package's
        ``Metric.note_count`` does.

        The bound advances by the smallest tensor argument's size an update
        (``_note_rows``); an update whose arguments are host values (strings,
        token lists) or that adds more than one per element to a count state
        calls this with what it adds. A host int: nothing is read from the
        device. The bound rides ``state_dict`` as ``_count_bound``.
        """
        self._count_bound += int(amount)

    # -------------------------------------------------- preemption-safe resume
    @property
    def epoch_watermark(self) -> int:
        """Batches folded into the accumulator this epoch: the next step index
        this metric expects. Persisted by ``state_dict``."""
        return self._epoch_watermark

    def guarded_update(self, step_index: int, *args: Any, span_end: Optional[int] = None, **kwargs: Any) -> bool:
        """Idempotent update: apply the batch only if ``step_index`` is not
        already folded in (returns whether it was applied). After a restore,
        replaying from any step at or before the checkpoint cannot
        double-count.

        ``span_end``: the one ``update`` carries the folded steps
        ``step_index .. span_end`` (inclusive) and the watermark advances past
        ``span_end``. All or nothing: a span below the watermark is a no-op, a
        span that straddles it raises ``ValueError``."""
        if span_end is None:
            if step_index < self._epoch_watermark:
                return False
            self.update(*args, **kwargs)
            return True
        if span_end < step_index:
            raise ValueError(f"span_end {span_end} < step_index {step_index}")
        if span_end < self._epoch_watermark:
            return False
        if step_index < self._epoch_watermark:
            raise ValueError(
                f"span [{step_index}, {span_end}] straddles the epoch watermark {self._epoch_watermark}: split at"
                " the watermark and re-fold only the unapplied suffix"
            )
        self.update(*args, **kwargs)  # advances the watermark by one step...
        self._epoch_watermark += span_end - step_index  # ...plus the span's rest
        return True

    # ------------------------------------------------------------------ sync
    def _synced_state(self, dist_sync_fn: Optional[Callable] = None, state: Optional[State] = None,
                      timer: Optional[Callable[[float], None]] = None) -> State:
        """The cross-rank reduction of ``state`` (default: the current state, which stays as it is)."""
        state = self._current_state() if state is None else state
        if dist_sync_fn is not None:
            return host_gather(state, self._reductions, dist_sync_fn, timer=timer)
        if self._class_placement() is not None:
            from metrics_tpu_torch.parallel.sync import class_block_sync

            return class_block_sync(state, self._reductions, self._class_placement(), layouts=self._cat_layouts,
                                    device=self.device, timer=timer)
        return all_reduce_state(
            state, self._reductions, group=self.process_group, layouts=self._cat_layouts, device=self.device,
            timer=timer,
        )

    def _sync_dist(self, dist_sync_fn: Optional[Callable] = None,
                   timer: Optional[Callable[[float], None]] = None) -> None:
        """Replace the current state by its cross-rank reduction, then apply the
        ``check_finite`` policy (``quarantine`` keeps the local state when the
        synced one is poisoned; the sync never writes the local tensors)."""
        local = self._current_state()
        if TRACE.enabled:
            with _span("metric.sync_state", {"metric": type(self).__name__}) as sp:
                synced = self._synced_state(dist_sync_fn, timer=timer)
                if _DEVTIME.enabled:
                    _fence(synced)
                self._set_state(synced)
                self._guard_state_integrity("sync", local)
                self._note_state_bytes(sp)
            return
        self._set_state(self._synced_state(dist_sync_fn, timer=timer))
        self._guard_state_integrity("sync", local)
        self._note_state_bytes()

    def _dispatch_deferred(self, dist_sync_fn: Optional[Callable], attrs: Optional[Dict[str, Any]] = None,
                           label: str = "host_gather") -> Any:
        """Enter this step's sync without waiting: a handle of the host plane
        (``dist_sync_fn``, labelled ``label``) or of the bucketed plane.
        ``attrs`` go onto the ``deferred.dispatch`` span."""
        from metrics_tpu_torch.parallel.deferred import deferred_host_gather, deferred_sync_state

        state = self._current_state()
        if self._class_placement() is not None:
            raise ValueError("a class_sharded metric syncs its class blocks synchronously; `sync_lag` must be 0")
        if dist_sync_fn is not None:
            return deferred_host_gather(state, self._reductions, gather_fn=dist_sync_fn,
                                        watermark=self._epoch_watermark, label=label, attrs=attrs)
        return deferred_sync_state(state, self._reductions, group=self.process_group,
                                   watermark=self._epoch_watermark, layouts=self._cat_layouts, device=self.device,
                                   attrs=attrs)

    # ------------------------------------------------- the lag-k handle ring
    def _resolve_sync_lag(self) -> int:
        """This step's ring depth: the static ``sync_lag``, or the controller's
        verdict for ``"auto"`` (built at first use)."""
        lag = self.sync_lag
        if lag == "auto":
            if self._lag_controller is None:
                from metrics_tpu_torch.parallel.deferred import LagController

                self._lag_controller = LagController()
            return self._lag_controller.lag
        # the attribute-set path (library metrics) validates as loudly as __init__
        return _validate_sync_lag(lag, self.dist_sync_on_step) if lag else 0

    def _drain_handle_ring(self) -> None:
        """Resolve every in-flight handle in entry order and drop the views; a
        raise-policy exhaustion surfaces here."""
        ring = self._handle_ring
        while ring:
            ring.popleft().result()

    def _lagged_sync(self, dist_sync_fn: Optional[Callable], lag: int) -> Optional[State]:
        """The deferred per-step sync: enter this step's sync, push its handle,
        and resolve the oldest handles until the ring is back at ``lag``.
        Returns the newest resolved view, or ``None`` while the ring fills."""
        ring = self._handle_ring
        # the chosen depth rides the dispatch span: a trace shows why each
        # dispatch happened at the depth it did
        ring.append(self._dispatch_deferred(dist_sync_fn, {"lag_controller": lag} if TRACE.enabled else None))
        view = None
        while len(ring) > lag:
            oldest = ring.popleft()
            t0 = time.perf_counter()
            view = oldest.result()
            if self._lag_controller is not None and self.sync_lag == "auto":
                self._lag_controller.observe((time.perf_counter() - t0) * 1e3)
        record_deferred_depth(getattr(self, "_metric_label", type(self).__name__), len(ring))
        return view

    def _wrap_update(self, update: Callable) -> Callable:
        @functools.wraps(update)
        def wrapped_func(*args: Any, **kwargs: Any) -> Any:
            self._computed = None
            check_same_device(self.device, *args, *kwargs.values())
            self._note_rows(args, kwargs)
            revert_to = self._pre_update_snapshot()
            if TRACE.enabled:
                with _span("metric.update", {"metric": type(self).__name__}) as sp:
                    out = update(*args, **kwargs)
                    if _DEVTIME.enabled:  # the phase fence on the written states
                        _fence(self._current_state())
                    self._guard_state_integrity("update", revert_to)
                    self._note_state_bytes(sp)
                    return out
            out = update(*args, **kwargs)
            self._guard_state_integrity("update", revert_to)
            self._note_state_bytes()
            return out

        return wrapped_func

    def _note_state_bytes(self, span: Any = None) -> None:
        """Record this metric's state footprint: the ``state_bytes`` gauge of
        the counters snapshot, and an attr of the enclosing update / sync span
        (``export.summarize``'s ``state_bytes`` column). Read from the
        tensors' metadata; disabled observability pays one attribute check."""
        if not _COUNTERS.enabled and span is None:
            return
        nbytes = state_nbytes(self._current_state())
        # wrappers label their gauge (``Keyed(AUROC)``, not a bare ``Keyed``)
        record_state_bytes(getattr(self, "_metric_label", type(self).__name__), nbytes)
        if span is not None and getattr(span, "attrs", None) is not None:
            span.attrs["state_bytes"] = nbytes

    def _check_sync_count(self, dist_sync_fn: Optional[Callable]) -> None:
        """The debug sync-count check (``utils/debug.py``): gather this
        metric's synced-compute sequence number from every rank (one small
        ``all_gather``, or ``dist_sync_fn``) and raise when they disagree."""
        value = torch.tensor([self._sync_count], dtype=torch.int64, device=self.device)
        if dist_sync_fn is not None:
            counts = [int(c) for c in dist_sync_fn(value)]
        else:
            import torch.distributed as dist

            group = self.process_group if not isinstance(self.process_group, MeshHierarchy) else None
            world = dist.get_world_size(group)
            outs = [torch.empty_like(value) for _ in range(world)]
            record_collective("all_gather", value, fanout=world)
            dist.all_gather(outs, value, group=group)
            counts = torch.cat(outs).tolist()
        if len(set(counts)) > 1:
            raise RuntimeError(
                f"{self.__class__.__name__}: processes disagree on the synced-compute"
                f" sequence number ({counts}). Some rank called a synced compute() a"
                " different number of times — this pairs collectives wrongly and"
                " eventually deadlocks."
            )

    # -------------------------------------------------- state-integrity guard
    def _integrity_state(self) -> State:
        """The state view the ``check_finite`` scan runs over: the current
        state. Wrappers whose untouched rows rest at dtype extremes mask them."""
        return self._current_state()

    def _pre_update_snapshot(self) -> Optional[State]:
        """A copy of the state, taken only under the quarantine policy."""
        if self.check_finite == "quarantine":
            from metrics_tpu_torch.parallel.deferred import snapshot_state

            return snapshot_state(self._current_state())
        return None

    def _guard_state_integrity(self, where: str, revert_to: Optional[State] = None) -> None:
        """Apply the ``check_finite`` policy to the current state (one host
        read of the two counts)."""
        policy = self.check_finite
        if not policy:
            return
        nonfinite, saturated = torch.stack(state_integrity_counts(self._integrity_state())).tolist()
        if not nonfinite and not saturated:
            return
        detail = (
            f"{self.__class__.__name__} state failed the integrity scan after {where}: "
            f"{nonfinite} non-finite float element(s), {saturated} near-saturated integer count(s)."
        )
        if policy == "raise":
            raise StateCorruptionError(detail)
        if policy == "quarantine" and revert_to is not None:
            self._set_state(revert_to)
            self._computed = None
            record_fault("quarantined_updates")
            rank_zero_warn(detail + " The batch delta was quarantined (accumulator unchanged).", UserWarning)
            return
        rank_zero_warn(detail, UserWarning)

    def _wrap_compute(self, compute: Callable) -> Callable:
        @functools.wraps(compute)
        def wrapped_func(*args: Any, **kwargs: Any) -> Any:
            if TRACE.enabled:
                with _span("metric.compute", {"metric": type(self).__name__}):
                    out = compute_body(*args, **kwargs)
                    if _DEVTIME.enabled:
                        _fence(out)
                    return out
            return compute_body(*args, **kwargs)

        def compute_body(*args: Any, **kwargs: Any) -> Any:
            if not self._in_forward:  # the epoch compute, not a step's batch value
                self._host_warnings()
            if self._computed is not None:
                return self._computed
            # row-sharded states combine across ranks inside their sharded engine: no gather
            synced = self._to_sync and (self.dist_sync_fn is not None or dist_active()) and not self._states_own_sync()
            cache = self._current_state()
            lag = self._resolve_sync_lag() if synced and self.sync_lag and self._in_forward else 0
            if lag:
                # the debug sync-count check is skipped here: its own gather
                # would jump ahead of the deferred syncs in flight
                view = self._lagged_sync(self.dist_sync_fn, lag)
                self._sync_count += 1
                synced = view is not None  # the warm-up steps read the local delta
                if synced:
                    self._set_state(view)
                    self._guard_state_integrity("sync", cache)
                    self._note_state_bytes()
            elif synced:
                # entry order: a synchronous sync never overtakes in-flight deferred ones
                self._drain_handle_ring()
                if debug.sync_count_check_enabled():
                    self._check_sync_count(self.dist_sync_fn)
                self._sync_count += 1
                auto = self._lag_controller is not None and self.sync_lag == "auto" and self._in_forward
                self._sync_dist(self.dist_sync_fn, timer=self._lag_controller.observe if auto else None)
            try:
                self._computed = compute(*args, **kwargs)
            finally:
                if synced:
                    self._set_state(cache)
            # after the sync restore: state written here persists
            self._after_compute(self._computed)
            return self._computed

        return wrapped_func

    def _after_compute(self, result: Any) -> None:
        """Hook run by the wrapped ``compute`` after the sync restore. State
        written inside ``compute`` itself is discarded when a synced compute
        restores the local state; writes from this hook persist. Default:
        nothing."""

    def _host_warnings(self) -> None:
        """Warnings from host-side bookkeeping (``_count_bound``) at every epoch
        ``compute()``, before the cache is read: no device work. Default: none."""

    @abstractmethod
    def update(self) -> None:  # pylint: disable=E0202
        """Override to update registered state from a batch."""

    @abstractmethod
    def compute(self) -> Any:  # pylint: disable=E0202
        """Override to compute the final value from (synced) state."""

    # ------------------------------------------------------------- lifecycle
    def reset(self) -> None:
        """Reset all states to their defaults (in the ``astype`` dtype, if one
        was set). In-flight deferred syncs still complete, but a reset metric
        never reads their views."""
        self._computed = None
        self._count_bound = 0
        self._epoch_watermark = 0
        self._handle_ring = deque()
        self._set_state(self.init_state())
        if self._state_dtype is not None:
            self.astype(self._state_dtype)

    def clone(self) -> "Metric":
        return deepcopy(self)

    def __getstate__(self) -> dict:
        return {k: v for k, v in self.__dict__.items() if k not in _WRAPPER_ATTRS and k not in _LIVE_ATTRS}

    def __setstate__(self, state: dict) -> None:
        super().__setstate__(state)
        for name, default in (("check_finite", None), ("sync_lag", 0), ("_state_dtype", None), ("_placement", None),
                              ("_sync_count", 0)):
            self.__dict__.setdefault(name, default)
        # handles never travel: drop any ring a foreign __dict__ carried in
        self.__dict__["_handle_ring"] = deque()
        self.__dict__["_lag_controller"] = None
        self._wrap_methods()

    def astype(self, dtype: torch.dtype) -> "Metric":
        """Cast the floating-point states to ``dtype`` (integer states and
        sketch counts stay); later resets keep the cast."""
        self._state_dtype = dtype

        def cast(v: Tensor) -> Tensor:
            return v.to(dtype) if v.is_floating_point() else v

        for name in self._defaults:
            value = getattr(self, name)
            if isinstance(value, list):
                setattr(self, name, [cast(v) for v in value])
            elif isinstance(value, PaddedBuffer):
                setattr(self, name, PaddedBuffer(cast(value.data), value.count))
            elif is_sketch(value):
                setattr(self, name, type(value)(cast(value.counts)))
            else:
                setattr(self, name, cast(value))
        return self

    def state_pytree(self) -> State:
        """Every current state, as a dict."""
        return self._current_state()

    def _apply(self, fn: Callable, *args: Any, **kwargs: Any) -> "Metric":
        # ``.to()`` / ``.cuda()`` move the registered states; the templates
        # and list states follow, and ``self.device`` records where they went
        super()._apply(fn, *args, **kwargs)
        self._defaults = {k: fn(v) if isinstance(v, Tensor) else v for k, v in self._defaults.items()}
        for name in self._defaults:
            value = getattr(self, name)
            if isinstance(value, PaddedBuffer):
                setattr(self, name, PaddedBuffer(fn(value.data), fn(value.count)))
            elif is_sketch(value):
                setattr(self, name, type(value)(fn(value.counts)))
            elif isinstance(value, list):
                setattr(self, name, [fn(v) for v in value])
        self.device = fn(torch.empty(0, device=self.device)).device
        return self

    # ------------------------------------------------------------ checkpoint
    def persistent(self, mode: bool = False) -> None:
        for key in self._persistent:
            self._persistent[key] = mode

    def state_dict(self, destination: Optional[dict] = None, prefix: str = "") -> dict:  # type: ignore[override]
        """Persistent states as host numpy, in the JAX package's key layout."""
        destination = {} if destination is None else destination
        for key in self._defaults:
            if self._persistent[key]:
                value = getattr(self, key)
                # host copies, never views: the planes update CPU states in place
                if isinstance(value, list):
                    destination[prefix + key] = [host_copy(v) for v in value]
                elif isinstance(value, PaddedBuffer):
                    destination[prefix + key] = {"data": host_copy(value.data), "count": host_copy(value.count)}
                elif is_sketch(value):
                    destination[prefix + key] = {"sketch_counts": host_copy(value.counts)}
                else:
                    destination[prefix + key] = host_copy(value)
        destination[prefix + "_count_bound"] = np.asarray(self._count_bound, dtype=np.int64)
        destination[prefix + "_epoch_watermark"] = np.asarray(self._epoch_watermark, dtype=np.int64)
        return destination

    def load_state_dict(self, state_dict: dict, prefix: str = "") -> None:  # type: ignore[override]
        """Load states saved by either package's ``state_dict``; values are cast
        to this metric's state dtypes and placed on ``self.device``."""
        for key, default in self._defaults.items():
            if prefix + key not in state_dict:
                continue
            value = state_dict[prefix + key]
            if isinstance(value, dict) and set(value) == {"data", "count"}:
                data = torch.tensor(np.asarray(value["data"]), device=self.device)
                count = torch.tensor(np.asarray(value["count"]), dtype=torch.int64, device=self.device)
                if isinstance(default, list):  # resumes a buffer: later resets rebuild it
                    self._defaults[key] = _BufferSpec(data.shape[0], tuple(data.shape[1:]), data.dtype)
                setattr(self, key, PaddedBuffer(data, count))
            elif isinstance(value, dict) and set(value) == {"sketch_counts"}:
                # the live state's kind; the JAX package saves int32 counts
                # without x64, so they take the spec's dtype
                current = getattr(self, key)
                if not is_sketch(current):
                    raise ValueError(f"checkpoint entry '{key}' holds sketch counts but the state is not a sketch")
                counts = torch.tensor(np.asarray(value["sketch_counts"]), dtype=default.dtype, device=self.device)
                setattr(self, key, type(current)(counts))
            elif isinstance(value, list):
                setattr(self, key, [torch.tensor(np.asarray(v), device=self.device) for v in value])
            else:
                setattr(self, key, torch.tensor(np.asarray(value), device=self.device, dtype=default.dtype))
        if prefix + "_count_bound" in state_dict:
            self._count_bound = int(state_dict[prefix + "_count_bound"])
        if prefix + "_epoch_watermark" in state_dict:
            self._epoch_watermark = int(state_dict[prefix + "_epoch_watermark"])

    # ---------------------------------------------------------- compute groups
    def _group_fingerprint(self) -> Optional[Any]:
        """Hashable identity of this metric's update and state plane, or None.

        Two metrics with equal fingerprints run the same ``update`` function
        (found on the MRO) with the same update-relevant config over the same
        state schema on the same device, so inside a ``MetricCollection`` one
        shared update delta serves them all.
        """
        attrs = type(self)._GROUP_UPDATE_ATTRS
        excluded = type(self)._GROUP_COMPUTE_ONLY_ATTRS
        if attrs is None and excluded is None:
            return None
        update_fn = next((vars(k)["update"] for k in type(self).__mro__ if "update" in vars(k)), None)
        try:
            if attrs is not None:
                config = tuple((a, _fingerprint_value(getattr(self, a, None))) for a in (*attrs, "capacity"))
            else:
                config = tuple(
                    (k, _fingerprint_value(v))
                    for k, v in sorted(vars(self).items())
                    if k not in _NON_CONFIG_ATTRS and k not in self._defaults and k not in excluded
                )
            schema = tuple(
                (n, _fingerprint_value(self._defaults[n]), _fingerprint_value(self._reductions[n]))
                for n in sorted(self._defaults)
            )
        except _Unfingerprintable:
            return None
        if self._placement is not None:  # members placed apart never share a delta or a sync
            return (update_fn, config, schema, str(self.device), ("placement", id(self._placement)))
        return (update_fn, config, schema, str(self.device))

    # -------------------------------------------------------------- plumbing
    def _filter_kwargs(self, **kwargs: Any) -> Dict[str, Any]:
        """Keep only kwargs accepted by this metric's ``update``."""
        _params = (inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)
        _sign_params = self._update_signature.parameters
        filtered_kwargs = {
            k: v for k, v in kwargs.items() if (k in _sign_params and _sign_params[k].kind not in _params)
        }
        return filtered_kwargs or kwargs

    def extra_repr(self) -> str:
        return f"device={self.device}"

    # ------------------------------------------------------------- operators
    def __hash__(self) -> int:
        # identity, as the JAX package's id-based hash: ``__eq__`` below composes
        return hash((type(self).__name__, id(self)))

    def __add__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.add, self, other)

    def __and__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_and, self, other)

    def __eq__(self, other: Any) -> "CompositionalMetric":  # type: ignore[override]
        return CompositionalMetric(torch.eq, self, other)

    def __floordiv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.floor_divide, self, other)

    def __ge__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.ge, self, other)

    def __gt__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.gt, self, other)

    def __le__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.le, self, other)

    def __lt__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.lt, self, other)

    def __matmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.matmul, self, other)

    def __mod__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.fmod, self, other)

    def __mul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.mul, self, other)

    def __ne__(self, other: Any) -> "CompositionalMetric":  # type: ignore[override]
        return CompositionalMetric(torch.ne, self, other)

    def __or__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_or, self, other)

    def __pow__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.pow, self, other)

    def __radd__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.add, other, self)

    def __rand__(self, other: Any) -> "CompositionalMetric":
        # bitwise_and is commutative
        return CompositionalMetric(torch.bitwise_and, self, other)

    def __rfloordiv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.floor_divide, other, self)

    def __rmatmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.matmul, other, self)

    def __rmod__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.fmod, other, self)

    def __rmul__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.mul, other, self)

    def __ror__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_or, other, self)

    def __rpow__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.pow, other, self)

    def __rsub__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.sub, other, self)

    def __rtruediv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.true_divide, other, self)

    def __rxor__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_xor, other, self)

    def __sub__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.sub, self, other)

    def __truediv__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.true_divide, self, other)

    def __xor__(self, other: Any) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_xor, self, other)

    def __abs__(self) -> "CompositionalMetric":
        return CompositionalMetric(torch.abs, self, None)

    def __inv__(self) -> "CompositionalMetric":
        return CompositionalMetric(torch.bitwise_not, self, None)

    def __invert__(self) -> "CompositionalMetric":
        return self.__inv__()

    def __neg__(self) -> "CompositionalMetric":
        return CompositionalMetric(_neg, self, None)

    def __pos__(self) -> "CompositionalMetric":
        return CompositionalMetric(torch.abs, self, None)


def _neg(tensor: Tensor) -> Tensor:
    # the reference's quirk, kept by the JAX package: ``-metric`` is ``-abs(value)``
    return -torch.abs(tensor)


class CompositionalMetric(Metric):
    """Lazy composition of two metrics (or a metric and a constant) under an operator.

    ``forward`` runs ONE forward per child metric and applies the operator to
    their batch values; ``update`` / ``reset`` / ``persistent`` reach both
    children; ``compute`` applies the operator to the children's computes.
    Each child syncs on its own, so the composition never syncs. Constants
    become tensors on the composition's device (the first child metric's).
    """

    def __init__(
        self,
        operator: Callable,
        metric_a: Union[Metric, int, float, Tensor],
        metric_b: Union[Metric, int, float, Tensor, None],
    ):
        child = metric_a if isinstance(metric_a, Metric) else metric_b
        super().__init__(device=child.device)
        self.op = operator
        self.metric_a = self._operand(metric_a)
        self.metric_b = self._operand(metric_b)

    def _operand(self, value: Any) -> Any:
        if value is None or isinstance(value, Metric):
            return value
        return torch.as_tensor(value, device=self.device)

    def _sync_dist(self, dist_sync_fn: Optional[Callable] = None,
                   timer: Optional[Callable[[float], None]] = None) -> None:
        # the child metrics sync themselves
        pass

    @property
    def _fusable(self) -> bool:
        # forward() is overridden below; the base dispatch never runs
        return False

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        """One forward per child; the composed batch value is the operator over theirs."""
        self._computed = None  # the children advanced: a cached epoch value is stale

        def _child(child: Any) -> Any:
            if isinstance(child, Metric):
                return child.forward(*args, **child._filter_kwargs(**kwargs))
            return child

        val_a = _child(self.metric_a)
        val_b = _child(self.metric_b)
        if not self.compute_on_step:
            return None
        # a child with compute_on_step=False yields no batch value to compose
        if val_a is None or (isinstance(self.metric_b, Metric) and val_b is None):
            return None
        self._forward_cache = self.op(val_a) if val_b is None else self.op(val_a, val_b)
        return self._forward_cache

    def update(self, *args: Any, **kwargs: Any) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.update(*args, **self.metric_a._filter_kwargs(**kwargs))
        if isinstance(self.metric_b, Metric):
            self.metric_b.update(*args, **self.metric_b._filter_kwargs(**kwargs))

    def compute(self) -> Any:
        val_a = self.metric_a.compute() if isinstance(self.metric_a, Metric) else self.metric_a
        val_b = self.metric_b.compute() if isinstance(self.metric_b, Metric) else self.metric_b
        if val_b is None:
            return self.op(val_a)
        return self.op(val_a, val_b)

    def reset(self) -> None:
        self._computed = None
        if isinstance(self.metric_a, Metric):
            self.metric_a.reset()
        if isinstance(self.metric_b, Metric):
            self.metric_b.reset()

    def persistent(self, mode: bool = False) -> None:
        if isinstance(self.metric_a, Metric):
            self.metric_a.persistent(mode=mode)
        if isinstance(self.metric_b, Metric):
            self.metric_b.persistent(mode=mode)

    def extra_repr(self) -> str:
        return f"op={getattr(self.op, '__name__', self.op)}, device={self.device}"
