"""MetricCollection: several metrics sharing one update/forward call.

Counterpart of ``metrics_tpu/core/collections.py`` (the eager grouped path):

* construction from a list or dict, output-key prefix, per-member kwarg filtering;
* compute groups (``_group_map``): members whose update plane is identical
  (same ``update`` function, update-relevant config and state schema — see
  ``Metric._group_fingerprint``) share ONE update delta per step;
* ``forward``: one update per compute group, the delta merged into each
  member's own accumulator, each member's batch value computed from the
  delta. The port syncs whenever a ``torch.distributed`` group is
  initialized, even at world size 1. A step's ``dist_sync_on_step`` members
  share packed syncs (``_step_sync_packs``): first every member folds its
  batch into its accumulator, in member order (a singleton inside its own
  ``metric.forward`` span); then the eligible members' deltas (one a compute
  group) sync in ONE call of the bucketed plane, one ``all_reduce`` per
  (dtype, op) bucket of the whole step (``sync_state``), inside one
  ``collection.step_sync`` span; then each member computes its value from
  its slice, under its own ``check_finite`` policy, with the sync counted as
  its own. Eligible: ``dist_sync_on_step`` and ``compute_on_step``, no
  ``sync_lag``, no ``dist_sync_fn``, no ``class_sharded`` placement, no
  sharded engine (``_states_own_sync``), mergeable states, the base
  ``forward``, and the first such member's ``process_group``, in a step with
  at least two of them. So a packed step records no ``metric.sync_state``.
  The host plane (``dist_sync_fn``) packs only within a shared compute group
  (one gather of its delta); every other member syncs in its own
  ``compute``, as it would alone;
* ``compute``: the grouped epoch sync (the synchronous form of the JAX
  package's ``_grouped_host_sync``). When a ``torch.distributed`` group is
  initialized or a ``dist_sync_fn`` is set, each compute group of >= 2
  members in lockstep syncs ONCE, every such member computes from that one
  synced state and keeps its own local state. Lockstep is tracked on the
  host with no device work: after every collection-level write the
  collection records which state tensors each member holds, and a member
  found holding others (written outside the collection) is diverged until
  the next collection-level ``reset``. Diverged members, singleton groups
  and members with their own sync configuration sync on their own. With
  ``deferred_epoch_sync`` set, every shared group's sync is entered up front
  on the deferred plane, in the synchronous plane's group order, and the
  handles resolve in that order, so a group's member computes overlap the
  collectives of the groups after it;
* ``forward_batched``: a stack of batches, one collection ``forward`` a step
  (so one update a compute group a step), the per-step values stacked per
  key and each member's epoch value cached as ``Metric.forward_batched``
  caches it;
* the pure view (``init_state`` / ``update_state`` / ``compute_from_state`` /
  ``merge_states`` / ``sync_state``, ``pure()``) over a state deduplicated to
  one entry a compute group; ``sync_state`` flattens every entry into one
  call of the bucketed plane, one ``all_reduce`` per (dtype, op) bucket of
  the whole collection;
* ``state_dict`` / ``load_state_dict`` with the ``_compute_group_manifest``:
  one copy of each group's states plus a ``{member: representative}`` map,
  readable by the JAX package and back;
* ``clone(prefix=)``, a deep copy under another prefix;
* ``epoch_watermark`` (the least member watermark) and ``guarded_update``;
  ``sync_lag >= 1`` members take no part in the packed per-step sync (their
  syncs are deferred on their own handle rings), and ``sync_state(...,
  deferred=True)`` returns one handle that resolves to the nested state;
* the JAX package's spans, each with its device-time fence:
  ``collection.group_update`` (``{"group": rep}``), ``collection.step_sync``
  (``{"group": the pack's first member, "members": n}``),
  ``collection.host_sync`` (``{"group", "shared"}``, and ``"deferred":
  "yes"`` on the deferred epoch), ``collection.forward_batched`` and
  ``collection.compute`` (``{"members": n}``). The port has no fused
  collection step, so ``collection.fused_step`` has no site: ``forward`` is
  the JAX package's eager grouped path;
* the port's own spans: ``collection.forward`` (``{"members": n}``), the
  root of one step, and ``collection.lockstep`` (``{"elements": n}``, the
  list elements walked) around each lockstep check and record, in
  ``forward``, ``update`` and the epoch sync of ``compute``.
"""
from copy import deepcopy
from typing import Any, Dict, List, Optional, Set, Tuple, Union

import numpy as np
from torch import nn

from metrics_tpu_torch.core.metric import Metric, PureMetric
from metrics_tpu_torch.observability.counters import record_cache, record_deferred_depth
from metrics_tpu_torch.observability.devtime import DEVTIME as _DEVTIME
from metrics_tpu_torch.observability.devtime import fence as _fence
from metrics_tpu_torch.observability.trace import TRACE
from metrics_tpu_torch.observability.trace import span as _span
from metrics_tpu_torch.parallel.deferred import deferred_sync_state
from metrics_tpu_torch.parallel.sync import all_reduce_state, dist_active
from metrics_tpu_torch.utils.checks import shared_input_format
from metrics_tpu_torch.utils.data import tree_stack
from metrics_tpu_torch.utils.device import check_same_device


def _state_refs(metric: Metric) -> tuple:
    """The state objects a metric holds now. Every state write rebinds them
    (lists: their elements), so comparing by identity detects writes."""
    return tuple(tuple(v) if isinstance(v, list) else v for v in metric._current_state().values())


def _same_refs(a: Any, b: Any) -> bool:
    if type(a) is tuple and type(b) is tuple:
        return len(a) == len(b) and all(_same_refs(x, y) for x, y in zip(a, b))
    return a is b


def _list_elements(refs: Dict[str, tuple]) -> int:
    """The list-state elements the members' recorded refs hold (the
    ``collection.lockstep`` span's attr)."""
    return sum(len(v) for member in refs.values() for v in member if type(v) is tuple)


class MetricCollection(nn.ModuleDict):
    """Chain metrics with the same call pattern into a single object.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MetricCollection, Accuracy, Precision, Recall
        >>> target = torch.tensor([0, 2, 0, 2, 0, 1, 0, 2])
        >>> preds = torch.tensor([2, 1, 2, 0, 1, 2, 2, 2])
        >>> metrics = MetricCollection([Accuracy(device="cpu"),
        ...                             Precision(num_classes=3, average='macro', device="cpu"),
        ...                             Recall(num_classes=3, average='macro', device="cpu")])
        >>> {k: round(float(v), 4) for k, v in metrics(preds, target).items()}
        {'Accuracy': 0.125, 'Precision': 0.0667, 'Recall': 0.1111}
    """

    _GROUP_MANIFEST_KEY = "_compute_group_manifest"

    # The deferred grouped epoch sync (an attribute, as in the JAX package: set
    # it on an instance). Off by default in the port, where the synchronous
    # epoch plane is the one every earlier release ran.
    deferred_epoch_sync: bool = False

    def __init__(
        self,
        metrics: Union[List[Metric], Tuple[Metric, ...], Dict[str, Metric]],
        prefix: Optional[str] = None,
        compute_groups: bool = True,
    ):
        super().__init__()
        self._enable_compute_groups = bool(compute_groups)
        self._groups: Optional[Dict[str, str]] = None
        self._lockstep_refs: Dict[str, tuple] = {}
        self._diverged: Set[str] = set()
        if isinstance(metrics, dict):
            for name, metric in metrics.items():
                if not isinstance(metric, Metric):
                    raise ValueError(f"Value {metric} belonging to key {name} is not an instance of `Metric`")
                self[name] = metric
        elif isinstance(metrics, (tuple, list)):
            for metric in metrics:
                if not isinstance(metric, Metric):
                    raise ValueError(f"Input {metric} to `MetricCollection` is not a instance of `Metric`")
                name = metric.__class__.__name__
                if name in self:
                    raise ValueError(f"Encountered two metrics both named {name}")
                self[name] = metric
        else:
            raise ValueError("Unknown input to MetricCollection.")
        self.prefix = self._check_prefix_arg(prefix)

    def __setitem__(self, key: str, value: Metric) -> None:
        self._groups = None  # group assignment is membership-derived
        super().__setitem__(key, value)
        # a member that accumulated before joining is not in lockstep with its group
        if value._count_bound > 0:
            self._diverged.add(key)
        self._lockstep_refs[key] = _state_refs(value)

    def __delitem__(self, key: str) -> None:
        self._groups = None
        super().__delitem__(key)
        self._lockstep_refs.pop(key, None)
        self._diverged.discard(key)

    # ------------------------------------------------------ lockstep tracking
    def _lockstep_check(self) -> None:
        """Mark members whose states were written outside the collection."""
        if TRACE.enabled:
            with _span("collection.lockstep", {"elements": _list_elements(self._lockstep_refs)}):
                self._lockstep_compare()
            return
        self._lockstep_compare()

    def _lockstep_compare(self) -> None:
        for k, m in self.items():
            if not _same_refs(self._lockstep_refs.get(k), _state_refs(m)):
                self._diverged.add(k)

    def _lockstep_record(self) -> None:
        if TRACE.enabled:
            attrs: Dict[str, Any] = {}
            with _span("collection.lockstep", attrs):
                self._lockstep_refs = {k: _state_refs(m) for k, m in self.items()}
                attrs["elements"] = _list_elements(self._lockstep_refs)
            return
        self._lockstep_refs = {k: _state_refs(m) for k, m in self.items()}

    # ---------------------------------------------------------- compute groups
    def _group_map(self) -> Dict[str, str]:
        """member name -> group representative name (identity map when off).
        The representative is the group's first member in collection order."""
        record_cache("group", self._groups is not None)
        if self._groups is None:
            groups: Dict[str, str] = {}
            reps: Dict[Any, str] = {}
            for name, metric in self.items():
                key = metric._group_fingerprint() if self._enable_compute_groups else None
                groups[name] = name if key is None else reps.setdefault(key, name)
            self._groups = groups
        return self._groups

    @property
    def compute_groups(self) -> Dict[str, Tuple[str, ...]]:
        """The resolved groups: representative name -> member names."""
        by_rep: Dict[str, list] = {}
        for name, rep in self._group_map().items():
            by_rep.setdefault(rep, []).append(name)
        return {rep: tuple(members) for rep, members in by_rep.items()}

    def _eager_shared_groups(self) -> Dict[str, str]:
        """member -> representative, for groups of >= 2 members with mergeable states."""
        gm = self._group_map()
        sizes: Dict[str, int] = {}
        for rep in gm.values():
            sizes[rep] = sizes.get(rep, 0) + 1
        return {k: rep for k, rep in gm.items() if sizes[rep] > 1 and self[rep]._fusable}

    # ------------------------------------------------------ packed step sync
    @staticmethod
    def _packs_step_sync(m: Metric) -> bool:
        """Whether member ``m`` may sync its batch delta in a pack, outside
        its own ``compute``: a synced batch value, no deferred ring, no class
        blocks, no sharded engine, mergeable states and the base forward."""
        return (m.dist_sync_on_step and m.compute_on_step and not m.sync_lag and m._class_placement() is None
                and not m._states_own_sync() and m._fusable and type(m).forward is Metric.forward)

    def _step_sync_packs(self, shared: Dict[str, str]) -> List[List[str]]:
        """The step's packed syncs: lists of at least two members whose batch
        deltas sync in ONE call. The bucketed plane's pack holds every member
        without a ``dist_sync_fn`` and with the first such member's
        ``process_group``, from any compute group. The host plane gathers one
        compute group's delta at a time: a pack a shared group, of its members
        with the ``dist_sync_fn`` and ``process_group`` of the first. Members
        in no pack sync on their own."""
        bucketed: List[str] = []
        hosted: Dict[str, List[str]] = {}
        active = dist_active()
        for k, m in self.items():
            if not self._packs_step_sync(m):
                continue
            if m.dist_sync_fn is None:
                if active:
                    bucketed.append(k)
            elif k in shared:
                hosted.setdefault(shared[k], []).append(k)
        packs: List[List[str]] = []
        for members in (bucketed, *hosted.values()):
            if not members:
                continue
            lead = self[members[0]]
            pack = [k for k in members
                    if self[k].dist_sync_fn is lead.dist_sync_fn and self[k].process_group == lead.process_group]
            if len(pack) >= 2:
                packs.append(pack)
        return packs

    @staticmethod
    def _member_fold(m: Metric, args: tuple, kwargs: dict) -> Dict[str, Any]:
        """A packed singleton's forward up to its value: the batch delta
        folded into its accumulator, inside its own ``metric.forward`` span,
        so the member's kernels launch inside that range."""
        if TRACE.enabled:
            with _span("metric.forward", {"metric": type(m).__name__}):
                delta = m._fold_batch(*args, **kwargs)
                if _DEVTIME.enabled:
                    _fence((delta, m._current_state()))
                return delta
        return m._fold_batch(*args, **kwargs)

    def _packed_values(self, pack: List[str], shared: Dict[str, str], deltas: Dict[str, Any]) -> Dict[str, Any]:
        """ONE sync of a pack's batch deltas (an entry a compute group), then
        each member's batch value from its entry under its own
        ``check_finite`` policy."""
        entries = {shared.get(k, k): deltas[shared.get(k, k)] for k in pack}
        for k in pack:
            self[k]._enter_sync()
        lead = self[pack[0]]
        if TRACE.enabled:
            with _span("collection.step_sync", {"group": pack[0], "members": len(pack)}):
                synced = self._synced_entries(lead, entries)
                if _DEVTIME.enabled:
                    _fence(synced)
        else:
            synced = self._synced_entries(lead, entries)
        values: Dict[str, Any] = {}
        for k in pack:
            m, entry = self[k], shared.get(k, k)
            m._forward_cache = values[k] = m._value_of_synced(synced[entry], entries[entry])
        return values

    def _synced_entries(self, lead: Metric, entries: Dict[str, Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
        if lead.dist_sync_fn is not None:  # the host plane: one compute group's delta
            (entry, delta), = entries.items()
            return {entry: lead._synced_state(lead.dist_sync_fn, state=delta)}
        return self.sync_state(entries, group=lead.process_group)

    def _group_delta(self, rep: str, args: tuple, kwargs: dict) -> Dict[str, Any]:
        """ONE batch delta for a compute group, from its representative."""
        rm = self[rep]
        check_same_device(rm.device, *args, *kwargs.values())
        if TRACE.enabled:
            with _span("collection.group_update", {"group": rep}):
                delta = rm._run_update_on_state(rm.init_state(), *args, **rm._filter_kwargs(**kwargs))
                if _DEVTIME.enabled:
                    _fence(delta)
                return delta
        return rm._run_update_on_state(rm.init_state(), *args, **rm._filter_kwargs(**kwargs))

    # --------------------------------------------------------------- forward
    def forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Forward every member with the compute-group delta shared; kwargs
        are filtered per member signature. Input formatting is memoized for
        the step, so groups over the same ``(preds, target)`` format it once.
        This is the JAX package's eager grouped forward; the port has no fused
        collection step, so no ``collection.fused_step`` span is recorded.
        Traced, the step is one ``collection.forward`` span, the root of its
        member and lockstep spans."""
        if TRACE.enabled:
            with _span("collection.forward", {"members": len(self)}):
                return self._forward(*args, **kwargs)
        return self._forward(*args, **kwargs)

    def _forward(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        self._lockstep_check()
        with shared_input_format():
            out = self._forward_eager_body(*args, **kwargs)
        self._lockstep_record()
        return out

    def _forward_eager_body(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        shared = self._eager_shared_groups()
        packs = self._step_sync_packs(shared)
        packed = {k for pack in packs for k in pack}
        deltas: Dict[str, Any] = {}  # a compute group's representative, or a packed singleton -> its batch delta
        values: Dict[str, Any] = {}
        for k, m in self.items():
            kw = m._filter_kwargs(**kwargs)
            rep = shared.get(k)
            if rep is None:
                if k in packed:
                    deltas[k] = self._member_fold(m, args, kw)
                else:
                    values[k] = m(*args, **kw)
                continue
            if rep not in deltas:
                deltas[rep] = self._group_delta(rep, args, kwargs)
            m._computed = None
            m._forward_cache = None
            m._note_rows(args, kw)
            m._set_state(m.merge_states(m._current_state(), deltas[rep]))
            if k not in packed:
                if m.compute_on_step:
                    m._forward_cache = m._compute_on(deltas[rep], sync=m.dist_sync_on_step)
                values[k] = m._forward_cache
        for pack in packs:
            values.update(self._packed_values(pack, shared, deltas))
        return {self._set_prefix(k): values[k] for k in self}

    def forward_batched(self, *args: Any, **kwargs: Any) -> Dict[str, Any]:
        """Accumulate a whole stack of batches (leading axis = steps): one
        collection ``forward`` a step, so one update a compute group a step.
        Returns ``{key: per-step values stacked}`` (``None`` for a member with
        ``compute_on_step=False``). With positional arguments only, each
        member without ``dist_sync_on_step`` or a configured cross-process
        sync gets its epoch value cached, as ``Metric.forward_batched`` does."""
        data = (*args, *kwargs.values())
        if not data:
            raise ValueError("forward_batched needs at least one argument with a leading step axis")
        steps = int(data[0].shape[0])
        if TRACE.enabled:
            with _span("collection.forward_batched", {"members": len(self)}):
                per_step = self._forward_steps(steps, args, kwargs)
                if _DEVTIME.enabled:
                    _fence(per_step)
        else:
            per_step = self._forward_steps(steps, args, kwargs)
        out: Dict[str, Any] = {}
        for k, m in self.items():
            key = self._set_prefix(k)
            out[key] = tree_stack([step[key] for step in per_step]) if m.compute_on_step else None
            m._cache_batched_epoch(args, kwargs)
        return out

    def _forward_steps(self, steps: int, args: tuple, kwargs: dict) -> List[Dict[str, Any]]:
        return [self.forward(*(a[i] for a in args), **{k: v[i] for k, v in kwargs.items()}) for i in range(steps)]

    def update(self, *args: Any, **kwargs: Any) -> None:
        """Accumulate: one update per compute group, merged into every member."""
        self._lockstep_check()
        shared = self._eager_shared_groups()
        deltas: Dict[str, Any] = {}
        for k, m in self.items():
            kw = m._filter_kwargs(**kwargs)
            rep = shared.get(k)
            if rep is None:
                m.update(*args, **kw)
                continue
            if rep not in deltas:
                deltas[rep] = self._group_delta(rep, args, kwargs)
            m._computed = None
            m._note_rows(args, kw)
            m._set_state(m.merge_states(m._current_state(), deltas[rep]))
        self._lockstep_record()

    # -------------------------------------------------- preemption-safe resume
    @property
    def epoch_watermark(self) -> int:
        """The collection's resume point: the least member watermark (a step
        counts as applied once every member holds it)."""
        return min((m._epoch_watermark for m in self.values()), default=0)

    def guarded_update(self, step_index: int, *args: Any, **kwargs: Any) -> bool:
        """Idempotent collection update (see ``Metric.guarded_update``): the
        batch goes to every member only if ``step_index`` is not below the
        collection watermark."""
        if step_index < self.epoch_watermark:
            return False
        self.update(*args, **kwargs)
        return True

    def compute(self) -> Dict[str, Any]:
        if TRACE.enabled:
            with _span("collection.compute", {"members": len(self)}):
                out = self._compute_all()
                if _DEVTIME.enabled:
                    _fence(out)
                return out
        return self._compute_all()

    def _compute_all(self) -> Dict[str, Any]:
        for m in self.values():  # entry order: in-flight deferred syncs resolve before the epoch sync
            m._drain_handle_ring()
        shared = self._grouped_epoch_sync()
        return {self._set_prefix(k): shared[k] if k in shared else m.compute() for k, m in self.items()}

    def _grouped_epoch_sync(self, deferred: Optional[bool] = None) -> Dict[str, Any]:
        """ONE cross-rank sync per compute group: {member: computed value} for
        the members it served. A group shares its sync among the members that
        are in lockstep, have no cached value, and sync through the same
        ``dist_sync_fn`` and ``process_group`` as the group's representative;
        at least two must. Each computes from the synced state and gets its
        own state back.

        Deferred form (``deferred``, default :attr:`deferred_epoch_sync`):
        every group's sync is entered first, in group order, through
        ``Metric._dispatch_deferred`` (the host plane's single FIFO worker for
        a ``dist_sync_fn``, else the bucketed plane's collectives entered on
        this thread), then the handles resolve in the same order. The
        collectives and their order are the synchronous plane's; members this
        plane does not serve sync after every handle has resolved, where the
        synchronous plane syncs them. ``class_sharded`` groups sync their
        class blocks synchronously, so a collection holding one takes the
        synchronous plane for every group."""
        self._lockstep_check()
        plans = self._epoch_plans()
        if not plans:
            return {}
        deferred = self.deferred_epoch_sync if deferred is None else deferred
        handles = None
        if deferred and all(self[share[0]]._class_placement() is None for _rep, share in plans):
            handles = [self[share[0]]._dispatch_deferred(self[rep].dist_sync_fn,
                                                         {"group": rep} if TRACE.enabled else None,
                                                         label="epoch_gather")
                       for rep, share in plans]
            record_deferred_depth(f"{type(self).__name__}.epoch", len(handles))
        out: Dict[str, Any] = {}
        for i, (rep, share) in enumerate(plans):
            if TRACE.enabled:
                attrs = {"group": rep, "shared": len(share)}
                if handles is not None:
                    attrs["deferred"] = "yes"
                with _span("collection.host_sync", attrs):
                    synced = self._epoch_synced(rep, share, handles, i)
                    if _DEVTIME.enabled:
                        _fence(synced)
            else:
                synced = self._epoch_synced(rep, share, handles, i)
            for k in share:
                m = self[k]
                cache = m._current_state()
                m._set_state(synced)
                m._to_sync = False
                try:
                    out[k] = m.compute()
                finally:
                    m._set_state(cache)
                    m._to_sync = True
        if handles is not None:
            record_deferred_depth(f"{type(self).__name__}.epoch", 0)
        return out

    def _epoch_synced(self, rep: str, share: List[str], handles: Optional[list], i: int) -> Dict[str, Any]:
        if handles is not None:
            return handles[i].result()
        return self[share[0]]._synced_state(self[rep].dist_sync_fn)

    def _epoch_plans(self) -> List[Tuple[str, List[str]]]:
        """(representative, sharing members) of every group the epoch sync
        shares, in group order."""
        active = dist_active()
        plans: List[Tuple[str, List[str]]] = []
        for rep, members in self.compute_groups.items():
            rep_m = self[rep]
            if len(members) < 2 or (rep_m.dist_sync_fn is None and not active) or rep_m._states_own_sync():
                continue
            # a member whose row-sharded states combine inside its sharded engine takes no gather
            share = [
                k for k in members
                if k not in self._diverged
                and self[k]._to_sync
                and self[k]._computed is None
                and self[k].dist_sync_fn is rep_m.dist_sync_fn
                and self[k].process_group is rep_m.process_group
                and not self[k]._states_own_sync()
            ]
            if len(share) >= 2:
                plans.append((rep, share))
        return plans

    def device_put(self, device_or_placement: Any) -> "MetricCollection":
        """Place every member's states (``Metric.device_put``): a device, or a
        placement policy such as ``row_sharded()`` / ``class_sharded(h)``.
        The members keep their lockstep: they were placed together."""
        for m in self.values():
            m.device_put(device_or_placement)
        self._groups = None  # the compute-group key holds the placement
        self._lockstep_record()
        return self

    def reset(self) -> None:
        for m in self.values():
            m.reset()
        # every member is back at its defaults: groups are in lockstep again
        self._diverged.clear()
        self._lockstep_record()

    def persistent(self, mode: bool = True) -> None:
        for m in self.values():
            m.persistent(mode)

    def clone(self, prefix: Optional[str] = None) -> "MetricCollection":
        """A deep copy of the collection (members, states and lockstep
        bookkeeping) whose output keys take ``prefix``; ``None`` drops the
        prefix, as in the JAX package."""
        mc = deepcopy(self)
        mc.prefix = self._check_prefix_arg(prefix)
        return mc

    # -------------------------------------------------------------- pure view
    def init_state(self) -> Dict[str, Dict[str, Any]]:
        """The joint state: one entry per compute-group representative (every
        member of a group accrues the same state), each the representative's
        fresh ``init_state``. ``update_state`` / ``merge_states`` /
        ``sync_state`` work on whatever entries they are given, so a full
        per-member state still works."""
        gm = self._group_map()
        return {k: m.init_state() for k, m in self.items() if gm[k] == k}

    def update_state(self, state: Dict[str, Dict[str, Any]], *args: Any, **kwargs: Any) -> Dict[str, Dict[str, Any]]:
        """Pure joint update of every entry; input formatting is memoized for
        the call, so entries over the same ``(preds, target)`` format it once."""
        with shared_input_format():
            return {k: self[k].update_state(state[k], *args, **self[k]._filter_kwargs(**kwargs)) for k in state}

    def compute_from_state(self, state: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
        """Every member's value, each from its own entry or its group's."""
        gm = self._group_map()
        return {self._set_prefix(k): m.compute_from_state(state[k] if k in state else state[gm[k]])
                for k, m in self.items()}

    def merge_states(self, a: Dict[str, Dict[str, Any]], b: Dict[str, Dict[str, Any]]) -> Dict[str, Dict[str, Any]]:
        return {k: self[k].merge_states(a[k], b[k]) for k in a}

    def sync_state(self, state: Dict[str, Dict[str, Any]], group: Optional[Any] = None,
                   deferred: bool = False) -> Any:
        """The cross-rank reduction of the joint state over ``group`` (default:
        the first entry's ``process_group``): the leaves of every entry go
        through ONE call of the bucketed plane, so the whole collection makes
        one ``all_reduce`` per (dtype, op) bucket and one gather for its
        gather states. The members' own states are left as they are. A
        :class:`~metrics_tpu_torch.parallel.placement.MeshHierarchy` as
        ``group`` stages every collective over its two levels.

        ``deferred=True`` enters the same collectives without waiting and
        returns one :class:`~metrics_tpu_torch.parallel.deferred.SyncHandle`
        that resolves to the same nested ``{member: {state: value}}`` dict.
        Under ``class_sharded`` each entry syncs its class blocks on its own
        (``Metric.sync_state``), and there is no deferred form."""
        class_placed = [k for k in state if self[k]._class_placement() is not None]
        if class_placed and group is None:
            # the class blocks sync an entry at a time (a block is a slice of one entry's states)
            if len(class_placed) != len(state):
                raise ValueError("sync_state: some entries are class_sharded and some are not; place the whole"
                                 " collection with one device_put")
            return {k: self[k].sync_state(s, deferred=deferred) for k, s in state.items()}
        flat = {(k, n): v for k, s in state.items() for n, v in s.items()}
        reductions = {(k, n): self[k]._reductions[n] for k, s in state.items() for n in s}
        layouts = {(k, n): self[k]._cat_layouts[n] for k, s in state.items() for n in s if n in self[k]._cat_layouts}
        first = self[next(iter(state))] if state else None
        if group is None and first is not None:
            group = first.process_group
        device = None if first is None else first.device
        structure = {k: tuple(s) for k, s in state.items()}

        def nest(synced: Dict[Any, Any]) -> Dict[str, Dict[str, Any]]:
            return {k: {n: synced[(k, n)] for n in names} for k, names in structure.items()}

        if deferred:
            return deferred_sync_state(flat, reductions, group=group, watermark=self.epoch_watermark, finish=nest,
                                       layouts=layouts, device=device)
        return nest(all_reduce_state(flat, reductions, group=group, layouts=layouts, device=device))

    def pure(self) -> PureMetric:
        """The pure view of the collection over the joint state."""
        return PureMetric(init=self.init_state, update=self.update_state, compute=self.compute_from_state,
                          merge=self.merge_states, sync=self.sync_state)

    def __repr__(self) -> str:
        inner = ",\n  ".join(f"{k}: {m!r}" for k, m in self.items())
        return f"MetricCollection(\n  {inner}\n)"

    # ----------------------------------------------------------- checkpoint
    @staticmethod
    def _entries_equal(a: Any, b: Any) -> bool:
        if type(a) is not type(b):
            return False
        if isinstance(a, list):
            return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
        if isinstance(a, dict):  # a buffer's {"data", "count"} or a sketch's {"sketch_counts"}
            return set(a) == set(b) and all(np.array_equal(a[k], b[k]) for k in a)
        return np.array_equal(a, b)

    def _states_match(self, rep: Metric, member: Metric) -> bool:
        a, b = rep.state_dict(), member.state_dict()
        return set(a) == set(b) and all(self._entries_equal(a[k], b[k]) for k in a)

    def state_dict(self, destination: Optional[dict] = None, prefix: str = "") -> dict:  # type: ignore[override]
        """Persistent states of every member with compute-group copies merged:
        one full copy per group, a ``{member: representative}`` manifest for
        members whose values equal their representative's, and each such
        member's ``_count_bound`` / ``_epoch_watermark`` kept per member."""
        destination = {} if destination is None else destination
        gm = self._group_map()
        manifest: Dict[str, str] = {}
        for name, m in self.items():
            rep = gm[name]
            if rep != name and self._states_match(self[rep], m):
                manifest[name] = rep
                destination[f"{prefix}{name}._count_bound"] = np.asarray(m._count_bound, dtype=np.int64)
                destination[f"{prefix}{name}._epoch_watermark"] = np.asarray(m._epoch_watermark, dtype=np.int64)
            else:
                m.state_dict(destination, prefix=f"{prefix}{name}.")
        destination[prefix + self._GROUP_MANIFEST_KEY] = dict(manifest)
        return destination

    def load_state_dict(self, state_dict: dict, prefix: str = "") -> None:  # type: ignore[override]
        """Load a (possibly group-merged) collection checkpoint: manifest
        members fan out from their representative's copy."""
        manifest = state_dict.get(prefix + self._GROUP_MANIFEST_KEY, {})
        gm = self._group_map()
        for name, m in self.items():
            src = manifest.get(name, name)
            m.load_state_dict(state_dict, prefix=f"{prefix}{src}.")
            if src != name:
                for attr in ("_count_bound", "_epoch_watermark"):
                    key = f"{prefix}{name}.{attr}"
                    if key in state_dict:
                        setattr(m, attr, int(state_dict[key]))
                # a fanned-out member holds its representative's values: in lockstep
                self._diverged.discard(name)
            elif gm[name] != name:
                # a grouped member saved from its own entry had diverged at save time
                self._diverged.add(name)
        self._lockstep_record()

    def _set_prefix(self, k: str) -> str:
        return k if self.prefix is None else self.prefix + k

    @staticmethod
    def _check_prefix_arg(prefix: Optional[str]) -> Optional[str]:
        if prefix is not None and not isinstance(prefix, str):
            raise ValueError("Expected input `prefix` to be a string")
        return prefix
