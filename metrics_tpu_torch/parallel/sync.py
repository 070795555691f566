"""Cross-rank state synchronization over ``torch.distributed`` (host plane).

Counterpart of the host plane of ``metrics_tpu/parallel/sync.py``. Two forms:

* :func:`all_reduce_state` — the default whenever a ``torch.distributed``
  process group is initialized (NCCL on the GPU, Gloo on the CPU). Reduce
  states are flattened into ONE bucket per (dtype, op) and each bucket is one
  ``all_reduce`` — the packed form ``coalesced_sync_state`` gives the in-jit
  plane of the JAX package. ``mean`` leaves ride the sum bucket and are then
  divided by the world size. ``process_group`` scopes the collective.
* :func:`host_gather` — when the caller passes a ``dist_sync_fn``
  (``fn(tensor) -> [tensor per rank]``): gather every state, stack (or
  flatten list states), then apply the per-state reduction, the reference
  ``_sync_dist`` semantics. The tests use it as a fake multi-rank world.

Sketch states (histogram, rank, quantile and count-min: a NamedTuple of one
integer ``counts`` tensor, ``dist_reduce_fx="sum"``) ride the sum bucket of
their dtype like any tensor: one ``all_reduce`` per state dtype of a group,
bit-exact, whatever the traffic.

Gather states — cat (list) states, stack (``None`` or callable) tensor
states and :class:`~metrics_tpu_torch.parallel.buffer.PaddedBuffer` states —
take the gather plane of :func:`all_reduce_state`: ONE ``all_gather`` of a
small int64 layout table (rows, valid count, dtype and item shape of every
gather state on every rank), then ONE padded ``all_gather`` per dtype, trimmed
on the host side to each rank's rows. A rank that never appended to a list
state still enters both collectives: it takes the state's dtype and item
shape from the table. Lists come out in rank-major order; buffers come out
compacted, every rank's valid rows at the front in rank order (the
``buffer_all_gather`` layout of the JAX package).

The guard plane (:class:`SyncGuard`, :func:`set_sync_guard`, the fault hook
that ``parallel/faults.py`` installs) wraps every collective call of both
forms: deadlines, retries with backoff, and a raise or degrade policy on
exhaustion. Every collective of a process is entered on the caller's thread,
in program order: a torch process group does not order collectives that two
threads issue, so the guard waits on ``async_op=True`` works with its
deadline instead of running attempts on threads, and the deferred plane
(``parallel/deferred.py``) enters its collectives at dispatch the same way.

Both forms are topology-aware. Pass a
:class:`~metrics_tpu_torch.parallel.placement.MeshHierarchy` as ``group=`` (or
as ``hierarchy=``) and every collective of :func:`all_reduce_state` runs in
two stages: a reduce bucket over the caller's slice (``ici``) first, then the
slice's result across slices (``dcn``); a gather across slices first, with the
unexpanded payload, then within the slice, the result put back into rank
order. A sum crosses the slow link once a slice, not once a rank.
``hierarchy=False`` forces the flat plane over the hierarchy's world; a
one-slice hierarchy is the flat plane over ``ici``, with the same
collectives. The host plane's counterpart is :func:`slice_leader_gather`:
one copy a slice of a state replicated within its slice. Every collective
records itself in ``observability.counters`` (kind, payload, crossing and
ring traffic) where it is entered.
"""
import functools
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch import Tensor

from metrics_tpu_torch.observability.counters import (
    record_collective,
    record_fault,
    record_gather_skip,
    record_states_synced,
)
from metrics_tpu_torch.observability.profiler import annotate
from metrics_tpu_torch.observability.trace import current_span
from metrics_tpu_torch.parallel.buffer import PaddedBuffer, buffer_compact_gathered, buffer_merge, handle_overflow
from metrics_tpu_torch.parallel.placement import HostHierarchy, MeshHierarchy
from metrics_tpu_torch.parallel.sketch import is_sketch, sketch_merge
from metrics_tpu_torch.utils.data import dim_zero_cat, dim_zero_max, dim_zero_mean, dim_zero_min, dim_zero_sum
from metrics_tpu_torch.utils.exceptions import InjectedFaultError, StateCorruptionError, SyncTimeoutError

# A reduction spec as accepted by ``Metric.add_state``.
ReduceFx = Union[str, Callable, None]

_STR_REDUCTIONS = ("sum", "mean", "cat", "min", "max")
_REDUCE_OPS = {"sum": "sum", "mean": "sum", "min": "min", "max": "max"}


def associative(fn: Callable) -> Callable:
    """Mark a callable ``dist_reduce_fx`` as an associative fold over axis 0.

    A plain callable is applied once to the ``(world, ...)`` stack after a
    gather, and nothing more is assumed of it. One marked associative promises
    that ``fn(torch.stack([a, b]))`` is a valid pairwise merge, so the one-delta
    ``forward`` folds a batch delta into the accumulator with it, as it does
    with ``sum`` / ``min`` / ``max``.
    """
    fn._mtpu_associative = True
    return fn


def is_associative(fx: ReduceFx) -> bool:
    return callable(fx) and getattr(fx, "_mtpu_associative", False)


def canonicalize_reduce_fx(fx: ReduceFx) -> ReduceFx:
    """Validate and canonicalize a ``dist_reduce_fx`` argument."""
    if fx is None or callable(fx):
        return fx
    if isinstance(fx, str) and fx in _STR_REDUCTIONS:
        return fx
    raise ValueError(f"`dist_reduce_fx` must be callable or one of {list(_STR_REDUCTIONS) + [None]}, got {fx!r}")


def stacked_reduction(fx: ReduceFx) -> Optional[Callable]:
    """The reduction applied to states stacked as ``(world, ...)`` after a gather."""
    if fx == "sum":
        return dim_zero_sum
    if fx == "mean":
        return dim_zero_mean
    if fx == "cat":
        return dim_zero_cat
    if fx == "min":
        return dim_zero_min
    if fx == "max":
        return dim_zero_max
    return fx  # None keeps the stack; a callable is applied to it


def merge_values(fx: ReduceFx, acc: Any, delta: Any) -> Any:
    """Pairwise merge of two state values: the same per-state reduction that
    syncs ranks also folds a batch delta into the accumulator."""
    if isinstance(acc, PaddedBuffer):
        return buffer_merge(acc, delta)
    if is_sketch(acc):
        return sketch_merge(acc, delta)
    if isinstance(acc, list):
        if isinstance(delta, PaddedBuffer):
            # the delta's first append promoted the state to a buffer (a metric
            # with ``capacity``); only an empty list accumulator can absorb it
            if acc:
                raise ValueError("Cannot merge a PaddedBuffer delta into a non-empty eager list state.")
            return delta
        return acc + list(delta)
    if fx == "sum":
        return acc + delta
    if fx == "min":
        return torch.minimum(acc, delta)
    if fx == "max":
        return torch.maximum(acc, delta)
    if is_associative(fx):
        return fx(torch.stack([acc, delta]))
    raise ValueError(f"Reduction {fx!r} has no pairwise merge; metric must use the double-update forward.")


def is_mergeable(fx: ReduceFx, default: Any) -> bool:
    """Whether a state with this reduction supports pairwise merge (one-delta forward)."""
    if isinstance(default, (list, PaddedBuffer)) or fx == "cat":
        return True
    return fx in ("sum", "min", "max") or is_associative(fx)


def dist_active() -> bool:
    """Whether a ``torch.distributed`` process group is initialized. The port
    syncs whenever one is, even at world size 1."""
    return dist.is_available() and dist.is_initialized()


# dtypes a gather state may have, by their code in the layout table
_GATHER_DTYPES = (
    torch.float32, torch.float64, torch.float16, torch.bfloat16, torch.int64, torch.int32,
    torch.int16, torch.int8, torch.uint8, torch.bool,
)
_MAX_ITEM_DIMS = 6
# layout table columns: known, is_buffer, rows, valid, dtype code, item ndim, item dims
_LAYOUT_WIDTH = 6 + _MAX_ITEM_DIMS


class _Layout(NamedTuple):
    """What the ranks agreed on for one gather state."""

    dtype: torch.dtype
    item: tuple
    is_buffer: bool
    rows: List[int]  # rows each rank sends (a buffer: its valid rows)
    pad_rows: int  # the most any rank sends: every rank pads to it
    capacity: int  # the largest capacity (a buffer) or row count


def _is_gather_state(value: Any, fx: ReduceFx) -> bool:
    return isinstance(value, (list, PaddedBuffer)) or fx not in _REDUCE_OPS


def _local_unit(value: Any, layout: Optional[tuple]) -> Tuple[Optional[Tensor], List[int]]:
    """One gather state as ``(rows tensor or None, layout row)``. ``layout`` is
    the ``(dtype, item_shape)`` the metric recorded for a list state, which
    lets an empty list still describe itself."""
    if isinstance(value, PaddedBuffer):
        data, is_buffer, valid = value.data, 1, None
    elif isinstance(value, list):
        if value:
            data = dim_zero_cat(value)
        elif layout is not None:
            data = torch.zeros((0, *layout[1]), dtype=layout[0])
        else:
            return None, [0] * _LAYOUT_WIDTH
        is_buffer, valid = 0, data.shape[0]
    else:
        data, is_buffer, valid = value.unsqueeze(0), 0, 1
    item = tuple(data.shape[1:])
    if len(item) > _MAX_ITEM_DIMS or data.dtype not in _GATHER_DTYPES:
        raise ValueError(f"cannot gather a state of dtype {data.dtype} with item shape {item}")
    row = [1, is_buffer, data.shape[0], 0 if valid is None else valid, _GATHER_DTYPES.index(data.dtype), len(item)]
    return data, row + list(item) + [0] * (_MAX_ITEM_DIMS - len(item))


def _tensor_of(value: Any) -> Tensor:
    """The tensor a reduce state syncs: a sketch's counts, or the state itself."""
    return value.counts if is_sketch(value) else value


def snapshot_state(state: Dict[Any, Any]) -> Dict[Any, Any]:
    """A copy of a state dict whose tensors share nothing with the live
    state: the double buffer of a sync that runs while the metric keeps
    updating in place."""

    def copy(value: Any) -> Any:
        if isinstance(value, Tensor):
            return value.clone()
        if isinstance(value, PaddedBuffer):
            return PaddedBuffer(value.data.clone(), value.count.clone())
        if is_sketch(value):
            return type(value)(value.counts.clone())
        if isinstance(value, list):
            return [copy(v) for v in value]
        return value

    return {k: copy(v) for k, v in state.items()}


# ------------------------------------------------------------- the guard plane
class SyncGuard(NamedTuple):
    """Deadline / retry / degrade policy for the port's sync collectives.

    Applied per collective call by every sync of the port: the ``all_reduce``
    buckets and the gather plane of :func:`all_reduce_state`, and the
    ``gather_fn`` calls of :func:`host_gather`. The default guard (no
    deadline, no finite check, no fault hook installed) keeps the unwrapped
    fast path: no copy, no thread, no ``Work`` handle.

    - ``deadline_s``: bound on how long one attempt may be waited on. The
      collective is entered as an ``async_op=True`` work on the caller's thread
      and polled; on expiry the wait is abandoned, not the work (a collective
      cannot be cancelled once entered), and the next attempt waits on the
      same work again instead of entering a second one, so every rank enters
      each collective exactly once. An injected stall burns the deadline
      before the collective is entered; its retry enters it.
    - ``max_retries`` / ``backoff_s``: transient failures (injected drops,
      deadline expiries, a corrupted payload) are retried up to
      ``max_retries`` times, sleeping ``backoff_s * 2**attempt`` between.
    - ``policy``: on exhaustion ``"raise"`` throws
      :class:`~metrics_tpu_torch.utils.exceptions.SyncTimeoutError` (or the
      ``StateCorruptionError`` that exhausted it); ``"degrade"`` returns the
      local state for the whole sync and counts ``degraded_computes``. A
      degraded sync still enters every remaining collective its peers enter,
      with the shapes they use, and waits on none of them but the gather
      plane's layout table, whose rows size the padded gathers.
    - ``check_finite``: scan each result for non-finite floats and
      near-saturated integers that the local payload did not carry, and
      retry on them (a fresh copy of the local payload is reduced again).
    """

    deadline_s: Optional[float] = None
    max_retries: int = 2
    backoff_s: float = 0.05
    policy: str = "raise"  # 'raise' | 'degrade'
    check_finite: bool = False


_SYNC_GUARD = SyncGuard()

# the fault hook (a parallel.faults.ChaosInjector when installed); consulted
# only on the guarded path
_FAULT_HOOK: Optional[Any] = None

# how often a deadline-bounded wait polls its work's completion
_POLL_S = 2e-4


def set_sync_guard(guard: Optional[SyncGuard]) -> SyncGuard:
    """Set the process-wide default :class:`SyncGuard`; returns the old one
    (``None`` restores the trivial default)."""
    global _SYNC_GUARD
    old = _SYNC_GUARD
    guard = guard if guard is not None else SyncGuard()
    if guard.policy not in ("raise", "degrade"):
        raise ValueError(f"SyncGuard.policy must be 'raise' or 'degrade', got {guard.policy!r}")
    _SYNC_GUARD = guard
    return old


def current_sync_guard() -> SyncGuard:
    return _SYNC_GUARD


class _DeadlineExceeded(Exception):
    """Internal: one attempt exceeded ``deadline_s`` (retryable)."""


def _payload_suspect(value: Tensor) -> bool:
    """The corruption signature of one payload: non-finite floats, or integers
    within ``max(iinfo.max // 2048, 1)`` of their dtype's range."""
    if value.is_floating_point() or value.is_complex():
        return not bool(torch.isfinite(value).all())
    if value.dtype == torch.bool:
        return False
    info = torch.iinfo(value.dtype)
    margin = max(info.max // 2048, 1)
    return bool(((value >= info.max - margin) | (value <= info.min + margin)).any())


def _payload_corrupted(local: Tensor, result: List[Tensor]) -> bool:
    """Corruption signatures in a result that the local payload did not carry
    (a genuinely poisoned local state must not retry forever)."""
    if _payload_suspect(local):
        return False
    return any(_payload_suspect(part) for part in result)


class _Ready:
    """A collective call that has already returned its result."""

    __slots__ = ("result",)

    def __init__(self, result: List[Tensor]):
        self.result = result

    def done(self) -> bool:
        return True

    def wait(self, deadline_s: Optional[float]) -> List[Tensor]:
        return self.result


class _Issued:
    """A collective entered with ``async_op=True``: its work, and the function
    that reads the result once the work is done."""

    __slots__ = ("work", "read")

    def __init__(self, work: Any, read: Callable[[], List[Tensor]]):
        self.work, self.read = work, read

    def done(self) -> bool:
        return self.work.is_completed()

    def wait(self, deadline_s: Optional[float]) -> List[Tensor]:
        if deadline_s is not None and not self.work.is_completed():
            end = time.monotonic() + deadline_s
            while not self.work.is_completed():
                if time.monotonic() >= end:
                    raise _DeadlineExceeded(f"collective not complete within its {deadline_s}s deadline")
                time.sleep(_POLL_S)
        self.work.wait()  # NCCL: the current stream waits on the collective
        return self.read()


class _Call:
    """One logical collective call of a guarded sync."""

    __slots__ = ("idx", "value", "issue", "pending", "attempt", "result")

    def __init__(self, idx: int, value: Tensor, issue: Callable[[bool], Any]):
        self.idx, self.value, self.issue = idx, value, issue
        self.pending: Any = None
        self.attempt = 0
        self.result: Optional[List[Tensor]] = None


def _run_hook(hook: Any, site: str, idx: int, attempt: int, deadline_s: Optional[float]) -> None:
    """The fault hook before an attempt enters its collective, on this thread:
    a drop or a preemption raises; a stall sleeps, at most ``deadline_s``, and
    one that outlasts the deadline raises ``_DeadlineExceeded`` (the attempt is
    burnt before any collective was entered)."""
    seconds = hook.stall_for(site, idx, attempt)
    if deadline_s is not None and seconds > deadline_s:
        hook.stall(deadline_s)
        raise _DeadlineExceeded(f"attempt {attempt} of call {idx} stalled past its {deadline_s}s deadline")
    hook.stall(seconds)


class _GuardPlane:
    """The guard state of one sync: the site's call numbering, the degraded
    latch and the fault hook, captured when the sync starts.

    Call indexing: a sync numbers its collective calls at site
    ``"host_gather"`` in the order it enters them. :func:`all_reduce_state`
    enters one ``all_reduce`` per (dtype, op) bucket, in the order the
    buckets' first states appear in the state dict, then (when it holds
    gather states) the layout table's ``all_gather`` and one padded
    ``all_gather`` per dtype, in dtype-code order. :func:`host_gather` makes
    one ``gather_fn`` call per dtype for a packable gather
    (:func:`packable_gather`), else one per tensor. The JAX package makes one
    packed gather per dtype, so a ``FaultSpec(call=i)`` hits the same call in
    both only where the state is one bucket in both (an int64 sum such as
    ``Accuracy``'s, int32 in the JAX package).

    ``reissue=False`` is the form whose results are read on the host plane's
    worker: a corrupted result cannot enter its collective again there (a
    collective entered from another thread would lose its place in the
    program order), so it goes straight to the policy.
    """

    __slots__ = ("guard", "hook", "site", "calls", "degraded", "reissue")

    def __init__(self, guard: Optional[SyncGuard] = None, site: str = "host_gather", reissue: bool = True):
        self.guard = guard if guard is not None else _SYNC_GUARD
        self.hook = _FAULT_HOOK
        self.site, self.calls, self.degraded, self.reissue = site, 0, False, reissue

    @property
    def active(self) -> bool:
        return self.hook is not None or self.guard.deadline_s is not None or self.guard.check_finite

    def call(self, value: Tensor, issue: Callable[[bool], Any], resolve: bool = True) -> _Call:
        """Enter one collective: ``issue(async_op)`` enters it on this thread
        and returns a ``_Ready`` or ``_Issued``. With ``resolve`` the call is
        waited on (``call.result``); without, only entered, and
        :meth:`resolve` waits on it later."""
        hook = self.hook
        idx = hook.note_call(self.site) if hook is not None else self.calls
        self.calls += 1
        call = _Call(idx, value, issue)
        if self.degraded:
            # entry order: the degraded sync still enters what its peers enter,
            # and does not wait on it (the gather plane's table aside, see
            # ``_gather_states``)
            call.pending = issue(True)
            call.result = [value]
            return call
        if not self.active:
            call.pending = issue(not resolve)
            if resolve:
                call.result = call.pending.wait(None)
            return call
        self._run(call, stop_after_issue=not resolve)
        return call

    def resolve(self, call: _Call) -> List[Tensor]:
        if call.result is None:
            if self.degraded:
                call.result = [call.value]  # entered already; a degraded sync does not wait on it
            elif not self.active:
                call.result = call.pending.wait(None)
            else:
                self._run(call, stop_after_issue=False)
        return call.result

    def _run(self, call: _Call, stop_after_issue: bool) -> None:
        guard, hook, site = self.guard, self.hook, self.site
        while True:
            try:
                if call.pending is None:
                    if hook is not None:
                        _run_hook(hook, site, call.idx, call.attempt, guard.deadline_s)
                    call.pending = call.issue(stop_after_issue or guard.deadline_s is not None)
                    if stop_after_issue:
                        return
                result = call.pending.wait(guard.deadline_s)  # an expiry keeps the work: the retry re-waits it
                if hook is not None:
                    result = hook.after_call(site, call.idx, call.attempt, result)
                if guard.check_finite and _payload_corrupted(call.value, result):
                    call.pending = None
                    raise StateCorruptionError(f"non-finite or saturated values appeared in sync payload"
                                               f" (call {call.idx})")
                call.result = result
                return
            except (InjectedFaultError, _DeadlineExceeded, StateCorruptionError) as err:
                call.attempt += 1
                record_fault("sync_retries")
                can_retry = self.reissue or not isinstance(err, StateCorruptionError)
                if can_retry and call.attempt <= guard.max_retries:
                    time.sleep(guard.backoff_s * (2 ** (call.attempt - 1)))
                    continue
                record_fault("sync_deadline_exceeded")
                if guard.policy == "degrade":
                    self.degraded = True
                    call.result = [call.value]
                    return
                if isinstance(err, StateCorruptionError):
                    raise
                raise SyncTimeoutError(
                    f"sync call {call.idx} failed after {guard.max_retries} retries"
                    f" (deadline {guard.deadline_s}s, policy 'raise'): {err}"
                ) from err


def _unguarded_plane(site: str = "host_gather") -> _GuardPlane:
    """A plane with no guard and no fault hook: the unwrapped fast path, for
    collectives that a caller guards as a whole (the sparse round)."""
    plane = _GuardPlane(SyncGuard(), site=site)
    plane.hook = None
    return plane


_DIST_OPS = {"sum": "SUM", "min": "MIN", "max": "MAX"}
_KIND_OF_OP = {"sum": "psum", "min": "pmin", "max": "pmax"}  # the JAX package's counter kinds


def _issue_all_reduce(flat: Tensor, op: str, group: Optional[Any], copy: bool,
                      crossing: str = "world") -> Callable[[bool], Any]:
    """Enter an ``all_reduce`` of ``flat`` by ``op`` (``"sum"`` / ``"min"`` /
    ``"max"``) over ``group``, counted at ``crossing``."""
    fanout = dist.get_world_size(group)

    def issue(async_op: bool) -> Any:
        buf = flat.clone() if copy else flat  # a retry reduces the local payload again
        record_collective(_KIND_OF_OP[op], buf, crossing=crossing, fanout=fanout)
        work = dist.all_reduce(buf, op=getattr(dist.ReduceOp, _DIST_OPS[op]), group=group, async_op=async_op)
        return _Issued(work, lambda: [buf]) if async_op else _Ready([buf])

    return issue


def _issue_all_gather(value: Tensor, world: int, group: Optional[Any], crossing: str = "world") -> Callable[[bool], Any]:
    def issue(async_op: bool) -> Any:
        outs = [torch.empty_like(value) for _ in range(world)]
        record_collective("all_gather", value, crossing=crossing, fanout=world)
        work = dist.all_gather(outs, value, group=group, async_op=async_op)
        return _Issued(work, lambda: outs) if async_op else _Ready(outs)

    return issue


# ---------------------------------------------------------- the two-level plane
class _Topology(NamedTuple):
    """Where one sync's collectives run: over ``group`` (flat, counted at
    ``crossing``), or in two stages over ``hierarchy``."""

    group: Optional[Any]
    hierarchy: Optional[MeshHierarchy]
    crossing: str

    @property
    def world(self) -> int:
        return self.hierarchy.size if self.hierarchy is not None else dist.get_world_size(self.group)


def _resolve_hierarchy(group: Any, hierarchy: Union[MeshHierarchy, bool, None] = None) -> _Topology:
    """The topology of a sync, with the degenerate cases folded.

    A :class:`MeshHierarchy` passed as ``group`` is taken as the hierarchy;
    ``hierarchy=False`` forces the flat plane over the hierarchy's world (one
    collective a bucket, counted at ``world``); a one-slice hierarchy is the
    flat plane over its ``ici`` group, with the same collectives, counted at
    ``ici``."""
    if hierarchy is False:
        return _Topology(group.world if isinstance(group, MeshHierarchy) else group, None, "world")
    if hierarchy is None and isinstance(group, MeshHierarchy):
        hierarchy = group
    if hierarchy is None:
        return _Topology(group, None, "world")
    if hierarchy.slices == 1:
        return _Topology(hierarchy.ici, None, "ici")
    return _Topology(hierarchy.world, hierarchy, "world")


def _reduce_call(plane: "_GuardPlane", topo: _Topology, flat: Tensor, op: str, resolve: bool) -> "_Call":
    """Enter the reduction of one bucket. Two-level: over ``ici``, waited on,
    then the slice's result over ``dcn`` (the call returned). Each stage is one
    guarded call."""
    h = topo.hierarchy
    if h is None:
        return plane.call(flat, _issue_all_reduce(flat, op, topo.group, plane.active, topo.crossing), resolve=resolve)
    local = plane.call(flat, _issue_all_reduce(flat, op, h.ici, plane.active, "ici")).result[0]
    return plane.call(local, _issue_all_reduce(local, op, h.dcn, plane.active, "dcn"), resolve=resolve)


def _settled(plane: "_GuardPlane", call: "_Call", wait_degraded: bool) -> Optional[List[Tensor]]:
    """A gather call's per-rank tensors; on a degraded plane the entered work is
    waited on without a deadline when ``wait_degraded``, else ``None``."""
    if not plane.degraded:
        return call.result
    if wait_degraded and call.pending is not None:
        return call.pending.wait(None)
    return None


def _gather_call(plane: "_GuardPlane", topo: _Topology, value: Tensor,
                 wait_degraded: bool = False) -> Optional[List[Tensor]]:
    """``value`` of every rank of ``topo``, in rank order (``None``: the plane
    degraded and the result is not needed).

    Two-level: each rank exchanges its own payload with its position's peers
    across slices (``dcn``), then the ``(slices, ...)`` stack within its slice
    (``ici``); the slice-major blocks go back to rank order by the hierarchy's
    grid. A degraded rank still enters the second stage with its peers'
    shape, and not at all when no attempt entered the first."""
    h = topo.hierarchy
    if h is None:
        world = dist.get_world_size(topo.group)
        call = plane.call(value, _issue_all_gather(value, world, topo.group, topo.crossing))
        return _settled(plane, call, wait_degraded)
    first = plane.call(value, _issue_all_gather(value, h.slices, h.dcn, "dcn"))
    across = _settled(plane, first, wait_degraded)
    if across is None:
        if first.pending is not None:
            stack = value.unsqueeze(0).expand(h.slices, *value.shape).contiguous()
            plane.call(stack, _issue_all_gather(stack, h.per_slice, h.ici, "ici"))
        return None
    stack = torch.stack(across)
    blocks = _settled(plane, plane.call(stack, _issue_all_gather(stack, h.per_slice, h.ici, "ici")), wait_degraded)
    if blocks is None:
        return None
    out: List[Optional[Tensor]] = [None] * h.size
    for p, block in enumerate(blocks):
        for s in range(h.slices):
            out[h.grid[s][p]] = block[s]
    return out  # type: ignore[return-value]


# ------------------------------------------------------------ the gather plane
def _gather_states(
    state: Dict[str, Any], names: List[str], layouts: Dict[str, tuple], device: torch.device, topo: _Topology,
    plane: _GuardPlane,
) -> Dict[str, Any]:
    """Gather the named states across ranks: one layout all_gather, then one
    padded all_gather per dtype, sized by every rank's table row.

    A degraded plane still enters the padded gathers with the shapes its peers
    use, so it waits, without a deadline, on the table it entered: the one
    wait a degraded sync makes. A table that was never entered (every attempt
    dropped by a fault schedule that every rank shares) enters no padded
    gather either. A degraded plane's result is not assembled: the caller
    takes the local view."""
    world = topo.world
    units, rows = [], []
    for name in names:
        data, row = _local_unit(state[name], layouts.get(name))
        units.append(data)
        rows.append(row)
    table = torch.tensor(rows, dtype=torch.int64, device=device)
    for u, name in enumerate(names):
        if isinstance(state[name], PaddedBuffer):  # the count stays on the device: no host read
            table[u, 3] = state[name].count
    gathered_tables = _gather_call(plane, topo, table, wait_degraded=True)
    if gathered_tables is None:
        return {}  # no attempt entered the table: no rank enters a padded gather
    per_rank = torch.stack(gathered_tables).tolist()  # (world, units, width): ONE host read

    # agree on each state's layout: the first rank that knows it
    agreed: List[Optional[_Layout]] = []
    for u, name in enumerate(names):
        known = [per_rank[r][u] for r in range(world) if per_rank[r][u][0]]
        if not known:
            agreed.append(None)
            continue
        ref = known[0]
        for other in known[1:]:
            if other[1] != ref[1] or other[4] != ref[4] or other[5:6 + other[5]] != ref[5:6 + ref[5]]:
                raise ValueError(f"state {name!r} has another dtype, item shape or kind on some rank: {known}")
        is_buffer = bool(ref[1])
        rows = [min(per_rank[r][u][3], per_rank[r][u][2]) if is_buffer else per_rank[r][u][2] for r in range(world)]
        agreed.append(_Layout(_GATHER_DTYPES[ref[4]], tuple(ref[6:6 + ref[5]]), is_buffer, rows, max(rows),
                              max(per_rank[r][u][2] for r in range(world))))

    out: Dict[str, Any] = {}
    by_dtype: Dict[int, List[int]] = {}
    for u, lay in enumerate(agreed):
        if lay is None:
            out[names[u]] = []  # no rank holds a row or a layout: nothing to move
        else:
            by_dtype.setdefault(_GATHER_DTYPES.index(lay.dtype), []).append(u)
    for code in sorted(by_dtype):
        members = by_dtype[code]
        wire = torch.uint8 if _GATHER_DTYPES[code] == torch.bool else _GATHER_DTYPES[code]
        pieces = []
        for u in members:
            lay = agreed[u]
            data = units[u] if units[u] is not None else torch.zeros((0, *lay.item), dtype=lay.dtype)
            data = data[: lay.pad_rows].to(device=device, dtype=wire)
            if data.shape[0] < lay.pad_rows:
                data = torch.cat([data, data.new_zeros((lay.pad_rows - data.shape[0], *lay.item))])
            pieces.append(data.reshape(-1))
        flat = pieces[0] if len(pieces) == 1 else torch.cat(pieces)
        gathered = _gather_call(plane, topo, flat)
        if gathered is None:
            continue  # the caller takes the local view
        offset = 0
        for u in members:
            lay = agreed[u]
            size = lay.pad_rows * int(torch.Size(lay.item).numel())
            blocks = [g[offset: offset + size].view(lay.pad_rows, *lay.item).to(lay.dtype) for g in gathered]
            offset += size
            if lay.is_buffer:
                valid = torch.tensor([per_rank[r][u][3] for r in range(world)], dtype=torch.int64, device=device)
                out[names[u]] = buffer_compact_gathered(torch.stack(blocks), valid, capacity=lay.capacity)
            else:
                out[names[u]] = [b[:n] for b, n in zip(blocks, lay.rows)]
    return out


class StateSync:
    """One state sync of the bucketed plane, entered on the caller's thread.

    Built by :func:`dispatch_state_sync`: the reduce buckets' ``all_reduce``
    calls are entered (unfenced with ``deferred=True``) and the gather plane
    has run, since its padded gathers are sized by a host read of the layout
    table. :meth:`finish` waits on the buckets (under the guard) and
    assembles the synced state dict; :meth:`done` says whether it would wait.
    """

    def __init__(self, state: Dict[str, Any], reductions: Dict[str, ReduceFx], topo: _Topology,
                 layouts: Dict[str, tuple], device: Optional[torch.device], plane: _GuardPlane, deferred: bool):
        self.state, self.reductions, self.topo, self.layouts, self.plane = state, reductions, topo, layouts, plane
        record_states_synced(len(state))
        buckets: Dict[tuple, List[str]] = {}
        self.gather_names: List[str] = []
        for name, value in state.items():
            fx = reductions[name]
            if _is_gather_state(value, fx):
                self.gather_names.append(name)
            else:
                buckets.setdefault((_tensor_of(value).dtype, _REDUCE_OPS[fx]), []).append(name)
        if device is None:
            device = next((v.device for v in state.values() if isinstance(v, Tensor)), torch.device("cpu"))
        self.device = device
        # a bucket reduces a copy of its states (torch.cat copies), so the live
        # tensors are never written; under a guard each attempt reduces a fresh
        # copy of that, since a retry needs the local payload again
        self.calls = []
        for (_dtype, op), names in buckets.items():
            flat = torch.cat([_tensor_of(state[n]).reshape(-1) for n in names])
            self.calls.append((names, _reduce_call(plane, topo, flat, op, resolve=not deferred)))
        # a degraded sync returns the local state as it was at dispatch: the
        # buckets' payloads are copies already; a deferred sync, which the
        # caller may update in place before it finishes, copies its gather states
        self.local = state
        if deferred and plane.active and self.gather_names:
            self.local = dict(state, **snapshot_state({n: state[n] for n in self.gather_names}))
        self.gathered = (_gather_states(state, self.gather_names, layouts, device, topo, plane)
                         if self.gather_names else {})
        self._out: Optional[Dict[str, Any]] = None

    def done(self) -> bool:
        return all(call.result is not None or call.pending.done() for _names, call in self.calls)

    def finish(self) -> Dict[str, Any]:
        if self._out is not None:
            return self._out
        results = [(names, self.plane.resolve(call)[0]) for names, call in self.calls]
        if self.plane.degraded:
            record_fault("degraded_computes")
            _stamp_degraded_span()
            # the whole sync falls back to the local state, laid out as a world of one
            self._out = _assemble(self.state, self.reductions, self.gather_names,
                                  [(names, call.value) for names, call in self.calls],
                                  _local_gathered(self.local, self.gather_names, self.layouts), world=1)
        else:
            world = self.topo.world if any(self.reductions[n] == "mean" for n in self.state) else 1
            self._out = _assemble(self.state, self.reductions, self.gather_names, results, self.gathered, world)
        return self._out


def _stamp_degraded_span() -> None:
    """Mark the innermost open span ``degraded=yes``: the sync span of
    ``Metric._sync_dist``, the collection's step or host sync span, or the
    deferred plane's ``deferred.complete`` / ``deferred.fence``."""
    span = current_span()
    if span is None:
        return
    if span.attrs is None:
        span.attrs = {}
    span.attrs["degraded"] = "yes"


def _local_gathered(state: Dict[str, Any], names: List[str], layouts: Dict[str, tuple]) -> Dict[str, Any]:
    """The gather states as the gather plane lays out a world of one: the
    local view of a degraded sync."""
    out: Dict[str, Any] = {}
    for name in names:
        value = state[name]
        if isinstance(value, PaddedBuffer):
            out[name] = value
        elif isinstance(value, list):
            data, _row = _local_unit(value, layouts.get(name))
            out[name] = [] if data is None else [data]
        else:
            out[name] = [value.unsqueeze(0)]
    return out


def _assemble(state: Dict[str, Any], reductions: Dict[str, ReduceFx], gather_names: List[str],
              reduced: List[tuple], gathered: Dict[str, Any], world: int) -> Dict[str, Any]:
    """The synced state dict from the reduced buckets and the gathered states."""
    out = dict(state)
    for names, flat in reduced:
        offset = 0
        for n in names:
            v = _tensor_of(state[n])
            piece = flat[offset: offset + v.numel()].view(v.shape)
            offset += v.numel()
            if is_sketch(state[n]):
                out[n] = type(state[n])(piece)
            else:
                out[n] = piece / world if reductions[n] == "mean" else piece
    for name in gather_names:
        fx, value, parts = reductions[name], state[name], gathered[name]
        if isinstance(parts, PaddedBuffer) or not parts or isinstance(value, list) and fx is None:
            out[name] = parts
        elif isinstance(value, list):
            out[name] = stacked_reduction(fx)(parts)
        else:
            reduction = stacked_reduction(fx)
            stacked = torch.cat(parts)
            out[name] = reduction(stacked) if reduction is not None else stacked
    return out


def dispatch_state_sync(
    state: Dict[str, Any],
    reductions: Dict[str, ReduceFx],
    group: Optional[Any] = None,
    layouts: Optional[Dict[str, tuple]] = None,
    device: Optional[torch.device] = None,
    guard: Optional[SyncGuard] = None,
    deferred: bool = False,
    reissue: bool = True,
    hierarchy: Union[MeshHierarchy, bool, None] = None,
) -> StateSync:
    """Enter a state sync's collectives on this thread; see :class:`StateSync`.
    ``reissue=False`` when :meth:`StateSync.finish` runs on another thread
    (see ``_GuardPlane``). ``group`` / ``hierarchy``: see
    :func:`all_reduce_state`."""
    return StateSync(state, reductions, _resolve_hierarchy(group, hierarchy), layouts or {}, device,
                     _GuardPlane(guard, reissue=reissue), deferred)


def all_reduce_state(
    state: Dict[str, Any],
    reductions: Dict[str, ReduceFx],
    group: Optional[Any] = None,
    layouts: Optional[Dict[str, tuple]] = None,
    device: Optional[torch.device] = None,
    guard: Optional[SyncGuard] = None,
    timer: Optional[Callable[[float], None]] = None,
    hierarchy: Union[MeshHierarchy, bool, None] = None,
) -> Dict[str, Any]:
    """Sync a state dict across the ranks of ``group``.

    Sum / mean / min / max tensor states: one ``all_reduce`` per (dtype, op)
    bucket. Gather states (lists, ``None`` / callable / ``cat`` tensor states,
    PaddedBuffers): one layout ``all_gather`` plus one padded ``all_gather``
    per dtype, for all of them together. A list state comes back as a list of
    per-rank tensors in rank order (``cat``: one tensor); a tensor state
    stacks to ``(world, ...)`` and its reduction applies; a PaddedBuffer
    comes back compacted with capacity ``world * capacity``. ``layouts``
    holds the ``(dtype, item_shape)`` recorded for list states, ``device``
    where an empty rank builds its part. Returns a new dict; the input
    tensors are not modified.

    ``group`` may be a :class:`~metrics_tpu_torch.parallel.placement.
    MeshHierarchy` (or pass one as ``hierarchy=``): every collective then runs
    in two stages, sums over the slice first and gathers across slices first
    (see the module docstring), with the flat plane's values: integer buckets
    bit for bit, float sums rounded in another order. ``hierarchy=False``
    forces the flat plane.

    Every collective call runs under ``guard`` (default: the process-wide
    :func:`set_sync_guard` guard; see :class:`SyncGuard`); each stage of a
    two-level collective is one call. ``timer`` receives the milliseconds the
    call held this thread (the adaptive lag controller's lag-0 probe).
    """
    t0 = time.perf_counter() if timer is not None else 0.0
    with annotate("metric.sync"):
        out = dispatch_state_sync(state, reductions, group, layouts, device, guard, hierarchy=hierarchy).finish()
    if timer is not None:
        timer((time.perf_counter() - t0) * 1e3)
    return out


# -------------------------------------------------------------- the host plane
def class_block_sync(
    state: Dict[str, Any],
    reductions: Dict[str, ReduceFx],
    placement: Any,
    layouts: Optional[Dict[str, tuple]] = None,
    device: Optional[torch.device] = None,
    guard: Optional[SyncGuard] = None,
    timer: Optional[Callable[[float], None]] = None,
) -> Dict[str, Any]:
    """The sync of a ``class_sharded`` state (``parallel.placement``).

    ``placement.group`` is a :class:`MeshHierarchy`: ``ici`` the mp group,
    ``dcn`` the dp group. A reduce state the placement shards sends only this
    rank's class block (block ``p`` of ``L`` along its leading axis, ``p`` the
    rank's position in its slice) through :func:`all_reduce_state` over dp,
    with the replicated states; then the synced blocks are reassembled over
    mp, one ``all_gather_into_tensor`` a dtype. Ranks of one slice hold the
    same data, so the dp sum is the sum over the world's distinct data.
    Returns a new dict of full states; the input tensors are not modified."""
    from metrics_tpu_torch.parallel.placement import ClassBlock, group_rank

    h = placement.group
    per = h.per_slice
    position = group_rank(h) % per
    sharded = [n for n, v in state.items()
               if reductions[n] in _REDUCE_OPS and isinstance(placement(n, v), ClassBlock)]
    blocks = dict(state)
    for n in sharded:
        blocks[n] = state[n].chunk(per, 0)[position]
    out = all_reduce_state(blocks, reductions, group=h.dcn, layouts=layouts, device=device, guard=guard, timer=timer)
    by_dtype: Dict[torch.dtype, List[str]] = {}
    for n in sharded:
        by_dtype.setdefault(out[n].dtype, []).append(n)
    for names in by_dtype.values():
        flat = torch.cat([out[n].reshape(-1) for n in names])
        if dist_active():
            record_collective("all_gather", flat, crossing="ici", fanout=per)
            every = flat.new_empty(per * flat.numel())
            dist.all_gather_into_tensor(every, flat, group=h.ici)
            every = every.view(per, flat.numel())
        else:
            every = flat.unsqueeze(0)
        offset = 0
        for n in names:
            size = out[n].numel()
            out[n] = every[:, offset: offset + size].reshape(state[n].shape)
            offset += size
    return out


def packable_gather(fn: Callable) -> Callable:
    """Mark a ``gather_fn`` as value-based (``fn(x) -> [x of each rank]``), so
    that :func:`host_gather` packs every same-dtype tensor into one payload and
    makes one call per dtype. A gather that treats its argument as a
    reference keeps one call per tensor, so packing is opt-in."""
    fn._mtpu_packable = True
    return fn


def is_packable_gather(fn: Callable) -> bool:
    if getattr(fn, "_mtpu_packable", False):
        return True
    if isinstance(fn, functools.partial):
        return is_packable_gather(fn.func)
    return False


def slice_leader_gather(hierarchy: HostHierarchy) -> Callable:
    """A packable host gather that keeps one copy a slice.

    For states replicated within a slice (after a sync over the slice, or a
    replicated eval state), the flat gather returns every rank's identical
    copy. This one returns the slice leaders' copies, in slice order, so the
    reduction spans each slice once, and counts the exchange at the ``dcn``
    crossing with slice fanout. Every process enters the one world
    ``all_gather`` and keeps the leaders' rows, so every process of a slice
    sees the same result. The caller owns the invariant: states that differ
    within a slice take the flat plane."""
    if not isinstance(hierarchy, HostHierarchy):
        raise TypeError(f"slice_leader_gather needs a HostHierarchy (process -> slice map), got {hierarchy!r}")

    @packable_gather
    def leader_gather(value: Tensor) -> List[Tensor]:
        if not dist_active() or dist.get_world_size() == 1 or hierarchy.n_slices <= 1:
            return [value]  # one slice: the flat gather of one copy
        record_collective("process_allgather", value, crossing="dcn", fanout=hierarchy.n_slices)
        outs = _all_gather_world(value)
        return [outs[p] for p in hierarchy.leaders]

    return leader_gather


def _all_gather_world(value: Tensor) -> List[Tensor]:
    value = value.contiguous()
    outs = [torch.empty_like(value) for _ in range(dist.get_world_size())]
    dist.all_gather(outs, value)
    return outs


@packable_gather
def _world_gather(value: Tensor) -> List[Tensor]:
    """The host plane's default gather: every rank's tensor over the default
    world (the value itself outside a process group)."""
    if not dist_active():
        return [value]
    record_collective("process_allgather", value, crossing="world", fanout=dist.get_world_size())
    return _all_gather_world(value)


def _packed_gather_units(units: List[Tensor], gather: Callable[[Tensor], List[Tensor]]) -> List[List[Tensor]]:
    """Gather many tensors with one call per dtype: same-dtype units ravel into
    one payload and are sliced back per rank. A dtype with one unit passes the
    unit through as it is."""
    results: List[Optional[List[Tensor]]] = [None] * len(units)
    buckets: Dict[torch.dtype, List[int]] = {}
    for i, unit in enumerate(units):
        buckets.setdefault(unit.dtype, []).append(i)
    for indices in buckets.values():
        if len(indices) == 1:
            results[indices[0]] = gather(units[indices[0]])
            continue
        per_rank = gather(torch.cat([units[i].reshape(-1) for i in indices]))
        offset = 0
        for i in indices:
            size = units[i].numel()
            results[i] = [p[offset: offset + size].view(units[i].shape) for p in per_rank]
            offset += size
    return results  # type: ignore[return-value]


def host_gather(
    state: Dict[str, Any],
    reductions: Dict[str, ReduceFx],
    gather_fn: Optional[Callable[[Tensor], List[Tensor]]] = None,
    slice_leaders: Optional[HostHierarchy] = None,
    guard: Optional[SyncGuard] = None,
    timer: Optional[Callable[[float], None]] = None,
    reissue: bool = True,
) -> Dict[str, Any]:
    """Gather-then-reduce sync through a caller-supplied ``gather_fn``: every
    tensor is gathered, stacked (list states are flattened element-major) and
    reduced per state, as ``metrics_tpu.parallel.sync.host_gather`` does. A
    PaddedBuffer gathers its data and count and comes back as the dense
    concatenation of every rank's valid rows; each rank's count goes through
    the overflow policy. A :func:`packable_gather` makes one call per dtype.
    Without a ``gather_fn`` the gather is ``torch.distributed.all_gather``
    over the default world, or with ``slice_leaders`` (a
    :class:`~metrics_tpu_torch.parallel.placement.HostHierarchy`)
    :func:`slice_leader_gather`: one copy a slice.

    ``None`` states pass through; a state with nothing to move enters no
    gather (``gather_skips``). Every call runs under ``guard`` (see
    :class:`SyncGuard`; ``gather_fn`` itself runs on this thread, the deadline
    bounds an injected stall); a degraded sync reduces the local tensors
    alone. ``timer`` receives the milliseconds the gather calls held this
    thread; ``reissue=False`` is the host-plane worker's form (see
    ``_GuardPlane``)."""
    if gather_fn is None:
        gather_fn = slice_leader_gather(slice_leaders) if slice_leaders is not None else _world_gather
    units: List[Tensor] = []
    slots: Dict[str, tuple] = {}
    for name, value in state.items():
        if value is None:
            slots[name] = ("none",)
        elif is_sketch(value):
            slots[name] = ("sketch", len(units))
            units.append(value.counts)
        elif isinstance(value, PaddedBuffer):
            slots[name] = ("buffer", len(units), len(units) + 1)
            units.extend([value.data, value.count])
        elif isinstance(value, list):
            slots[name] = ("list", list(range(len(units), len(units) + len(value))))
            units.extend(value)
        else:
            slots[name] = ("array", len(units))
            units.append(value)
    if not units:
        record_gather_skip()
        return dict(state)

    plane = _GuardPlane(guard, reissue=reissue)

    def gather(value: Tensor) -> List[Tensor]:
        return plane.call(value, lambda _async_op: _Ready(gather_fn(value))).result

    t0 = time.perf_counter() if timer is not None else 0.0
    fn = gather if plane.active else gather_fn
    with annotate("metric.sync"):
        if is_packable_gather(gather_fn):
            gathered = _packed_gather_units(units, fn)
        else:
            gathered = [fn(u) for u in units]
    if timer is not None:
        timer((time.perf_counter() - t0) * 1e3)
    if plane.degraded:
        record_fault("degraded_computes")
        _stamp_degraded_span()
        gathered = [[u] for u in units]

    out: Dict[str, Any] = {}
    for name, value in state.items():
        fx, slot = reductions[name], slots[name]
        if slot[0] == "none":
            out[name] = None
        elif slot[0] == "sketch":
            out[name] = type(value)(stacked_reduction(fx)(torch.stack(list(gathered[slot[1]]))))
        elif slot[0] == "buffer":
            datas, counts = gathered[slot[1]], gathered[slot[2]]
            for g, c in zip(datas, counts):
                handle_overflow(name, int(c), g.shape[0])
            parts = [g[: int(c)] for g, c in zip(datas, counts)]
            out[name] = dim_zero_cat(parts) if parts else value.data[:0]
        elif slot[0] == "list":
            flat = [g for i in slot[1] for g in gathered[i]]
            reduction = stacked_reduction(fx)
            out[name] = reduction(flat) if reduction is not None else flat
        else:
            stacked = torch.stack(list(gathered[slot[1]]))
            reduction = stacked_reduction(fx)
            out[name] = reduction(stacked) if reduction is not None else stacked
    return out
