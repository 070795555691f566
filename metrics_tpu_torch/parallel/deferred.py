"""Deferred sync plane: snapshot copies, future-returning collectives, and a
background host plane.

Counterpart of ``metrics_tpu/parallel/deferred.py``. What carries over, and
what a mutable, eagerly executed port changes:

- **Snapshots are copies.** The JAX package's double buffer is free (its
  arrays are immutable, so holding the refs is the snapshot). The port's
  states are written in place (``index_add_``, ``+=``) and ``all_reduce``
  reduces in place, so a deferred sync reduces a copy: the bucketed plane's
  ``torch.cat`` of each bucket, and :func:`snapshot_state` for the host plane.
  The live metric keeps accumulating while the collective is in flight.
- **Collectives are entered at dispatch, on the caller's thread.** A torch
  process group does not order collectives that two threads issue, and ranks
  pair their collectives by entry order. So :func:`deferred_sync_state`
  enters the bucketed plane's ``all_reduce`` calls as ``async_op=True`` works
  at dispatch, in program order; the :class:`SyncHandle` (``"device"``)
  waits on them at ``result()``. ``done()`` is the works' ``is_completed()``.
  Gather states (lists, buffers) take the gather plane at dispatch, since its
  padded gathers are sized by a host read of the layout table.
- **The host plane runs host work.** :func:`deferred_host_gather` with a
  caller-supplied ``gather_fn`` runs ``host_gather`` verbatim on a single FIFO
  worker (the ``gather_fn`` is host code: the test worlds, a custom
  transport). Without one, the world's ``all_reduce`` buckets are entered at
  dispatch and the worker waits on them and runs ``finish``, so the fold lands
  even if nobody fences the handle. A corrupted result read on the worker
  goes to the guard's policy without a retry (a retry would enter a
  collective from the worker thread).
- **Epoch watermark and lag.** Every handle carries the dispatching metric's
  epoch watermark. ``Metric(sync_lag=k)`` keeps a ring of at most
  :data:`MAX_SYNC_LAG` handles; :class:`LagController` chooses ``k`` from the
  measured blocking waits for ``sync_lag="auto"``.

The ``deferred`` counters record dispatches, fences and completions, and the
spans ``deferred.dispatch`` (on the caller's thread, with ``plane`` and the
caller's ``attrs``), ``deferred.fence`` (``result()``'s wait, with ``plane``
and ``label``) and ``deferred.complete`` (the host plane's task, on the
worker thread's own span stack) time them. The JAX package's compiled-program cache
(``clear_program_cache``, ``_sync_program``) has no counterpart: the port
compiles nothing.
- **Deferred sparse rounds run on the worker.** A sparse round reads its union
  on the host between its two collectives, so :func:`deferred_sparse_sync`
  runs the whole round on the host plane's worker, as the JAX package does.
  Its collectives then come from another thread than the caller's, so the
  plane runs them on process groups of its own over the same ranks (made on
  every rank at its first deferred round), and a synchronous round of the
  plane first waits for its deferred ones.
"""
import atexit
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Dict, Optional

import torch
from torch import Tensor

from metrics_tpu_torch.observability.counters import record_deferred
from metrics_tpu_torch.observability.trace import TRACE
from metrics_tpu_torch.observability.trace import span as _span
from metrics_tpu_torch.parallel.buffer import PaddedBuffer
from metrics_tpu_torch.parallel.sketch import is_sketch
from metrics_tpu_torch.parallel.sync import (
    ReduceFx,
    StateSync,
    SyncGuard,
    current_sync_guard,
    dispatch_state_sync,
    dist_active,
    host_gather,
    packable_gather,
    snapshot_state,
)

__all__ = [
    "DeferredSyncPlane",
    "LagController",
    "MAX_SYNC_LAG",
    "SyncHandle",
    "deferred_host_gather",
    "deferred_sparse_sync",
    "deferred_sync_state",
    "drain_host_plane",
    "host_plane_submit",
    "snapshot_state",
]

# The lag-k handle ring's depth cap: each in-flight handle holds a snapshot
# and (host plane) a queued task, so a bounded ring keeps both finite.
MAX_SYNC_LAG = 8


# ------------------------------------------------------ background host plane
class _HostPlane:
    """The single FIFO worker of the deferred host plane.

    One worker by construction: tasks run in submission order. Built lazily
    (importing this module starts no thread), drained and joined at
    ``atexit``, and usable again after a ``shutdown``.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._pool: Optional[ThreadPoolExecutor] = None
        self._pending = 0

    def submit(self, fn: Callable, *args: Any) -> Future:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix="mtpu-torch-deferred-host")
            self._pending += 1
            future = self._pool.submit(fn, *args)
        future.add_done_callback(self._task_done)
        return future

    def _task_done(self, _future: Future) -> None:
        with self._lock:
            self._pending -= 1

    def pending(self) -> int:
        """Tasks submitted and not yet finished."""
        with self._lock:
            return self._pending

    def drain(self) -> None:
        """Wait for every queued task (a barrier, not a shutdown)."""
        with self._lock:
            pool = self._pool
        if pool is not None:
            pool.submit(lambda: None).result()

    def shutdown(self) -> None:
        """Run every queued task to completion, then join the worker.
        Idempotent; a later ``submit`` builds a fresh pool."""
        with self._lock:
            pool, self._pool = self._pool, None
        if pool is not None:
            pool.shutdown(wait=True)


_HOST_PLANE = _HostPlane()
atexit.register(_HOST_PLANE.shutdown)


def host_plane_submit(fn: Callable, *args: Any) -> Future:
    """Submit host work to the deferred host plane (single worker, FIFO)."""
    return _HOST_PLANE.submit(fn, *args)


def drain_host_plane() -> None:
    """Barrier: block until every task submitted so far has finished."""
    _HOST_PLANE.drain()


# ------------------------------------------------------ adaptive lag control
class LagController:
    """Chooses a deferred-sync depth from the measured blocking waits.

    Keeps an EWMA of the milliseconds the caller blocked on sync: above
    ``free_ms`` the depth deepens one step toward ``max_lag``; at or below it
    for ``calm_steps`` consecutive observations it shallows one step
    (hysteresis). ``observe`` is the whole feedback interface; ``lag`` the
    current verdict. The same arithmetic as the JAX package's, so a given
    sequence of waits gives the same lag trajectory.
    """

    def __init__(self, max_lag: int = MAX_SYNC_LAG, free_ms: float = 1.0, alpha: float = 0.5,
                 calm_steps: int = 16) -> None:
        if not (isinstance(max_lag, int) and 0 < max_lag <= MAX_SYNC_LAG):
            raise ValueError(
                f"`max_lag` must be an int in [1, {MAX_SYNC_LAG}] (the ring depth"
                f" cap bounds the rendezvous pool), got {max_lag!r}"
            )
        if not free_ms > 0:
            raise ValueError(f"`free_ms` must be > 0, got {free_ms!r}")
        if not 0 < alpha <= 1:
            raise ValueError(f"`alpha` must be in (0, 1], got {alpha!r}")
        if not calm_steps >= 1:
            raise ValueError(f"`calm_steps` must be >= 1, got {calm_steps!r}")
        self.max_lag = max_lag
        self.free_ms = float(free_ms)
        self.alpha = float(alpha)
        self.calm_steps = int(calm_steps)
        self.lag = 0
        self.wait_ms = 0.0  # EWMA of the measured blocking wait
        self._calm = 0
        self._observed = 0

    def observe(self, wait_ms: float) -> int:
        """Feed one measured blocking wait (ms); returns the updated lag."""
        wait_ms = float(wait_ms)
        self._observed += 1
        if self._observed == 1:
            self.wait_ms = wait_ms
        else:
            self.wait_ms = self.alpha * wait_ms + (1.0 - self.alpha) * self.wait_ms
        if self.wait_ms > self.free_ms:
            self._calm = 0
            if self.lag < self.max_lag:
                self.lag += 1
        else:
            self._calm += 1
            if self._calm >= self.calm_steps and self.lag > 0:
                self.lag -= 1
                self._calm = 0
        return self.lag

    def __repr__(self) -> str:
        return (f"LagController(lag={self.lag}, wait_ms={self.wait_ms:.3f},"
                f" max_lag={self.max_lag}, free_ms={self.free_ms})")


# ---------------------------------------------------------------- the future
class SyncHandle:
    """Future of a deferred sync: resolved on demand, read once, cached.

    Three backings share the interface:

    - ``"device"`` (:func:`deferred_sync_state`): a :class:`~metrics_tpu_torch.
      parallel.sync.StateSync` whose ``all_reduce`` works were entered at
      dispatch; ``result()`` waits on them under the captured guard, and on a
      CUDA state synchronizes the current stream, so the values are ready when
      it returns. ``timeout`` is ignored: an entered collective cannot be
      abandoned half way.
    - ``"host"`` (:func:`deferred_host_gather`): a host-plane future;
      ``result(timeout)`` joins it. A raise-policy exhaustion re-raises here
      (``SyncTimeoutError``); degrade returns the local snapshot.
    - ``"ready"``: a value known at dispatch.

    ``result()`` is idempotent: later calls return the cached state or raise
    the cached error. ``watermark`` is the dispatching metric's epoch
    watermark at snapshot time.
    """

    __slots__ = ("_kind", "_payload", "_finish", "_resolved", "_result", "_error", "_lock", "watermark", "label")

    def __init__(self, kind: str, payload: Any, finish: Optional[Callable[[Any], Any]] = None,
                 watermark: Optional[int] = None, label: str = "sync") -> None:
        if kind not in ("device", "host", "ready"):
            raise ValueError(f"unknown SyncHandle kind {kind!r}")
        self._kind = kind
        self._payload = payload
        self._finish = finish
        self._resolved = kind == "ready"
        self._result = payload if kind == "ready" else None
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self.watermark = watermark
        self.label = label

    def done(self) -> bool:
        """Whether ``result()`` would return without waiting."""
        if self._resolved:
            return True
        return self._payload.done()

    def result(self, timeout: Optional[float] = None) -> Any:
        """Wait and return the synced state (cached after the first call)."""
        with self._lock:
            if self._resolved:
                if self._error is not None:
                    raise self._error
                return self._result
            attrs = {"plane": self._kind, "label": self.label} if TRACE.enabled else None
            try:
                with _span("deferred.fence", attrs):
                    if self._kind == "host":
                        out = self._payload.result(timeout)
                    else:
                        out = self._payload.finish()
                        _synchronize(out)
                        record_deferred("completed")  # a device completion is its fence
                if self._finish is not None:
                    out = self._finish(out)
            except BaseException as err:
                self._error = err
                self._resolved = True
                self._payload = self._finish = None
                record_deferred("fenced")
                raise
            self._result = out
            self._resolved = True
            self._payload = self._finish = None
            record_deferred("fenced")
            return out


def _synchronize(state: Dict[Any, Any]) -> None:
    """Block until the current stream of the state's CUDA device is idle."""
    for value in state.values():
        tensor = _first_tensor(value)
        if tensor is not None:
            if tensor.is_cuda:
                torch.cuda.current_stream(tensor.device).synchronize()
            return


def _first_tensor(value: Any) -> Optional[Tensor]:
    if isinstance(value, Tensor):
        return value
    if isinstance(value, PaddedBuffer):
        return value.data
    if is_sketch(value):
        return value.counts
    if isinstance(value, list) and value:
        return _first_tensor(value[0])
    return None


# --------------------------------------------------- the deferred host plane
@packable_gather
def _own_rank(value: Tensor) -> list:
    """The gather of a world of one process."""
    return [value]


def deferred_host_gather(
    state: Dict[str, Any],
    reductions: Dict[str, ReduceFx],
    gather_fn: Optional[Callable] = None,
    guard: Optional[SyncGuard] = None,
    watermark: Optional[int] = None,
    label: str = "host_gather",
    finish: Optional[Callable[[Dict[str, Any]], Any]] = None,
    group: Optional[Any] = None,
    attrs: Optional[Dict[str, Any]] = None,
) -> SyncHandle:
    """Run a host-plane sync in the background; returns a ``"host"`` :class:`SyncHandle`.

    Snapshots ``state`` now (a copy: the caller may keep accumulating in
    place) under ``guard`` (default: the process-wide
    :func:`~metrics_tpu_torch.parallel.sync.current_sync_guard`, captured now
    so a later guard change cannot alter an in-flight sync).

    - With a ``gather_fn``, the single-worker host plane runs
      ``host_gather(snapshot, reductions, gather_fn, guard)`` verbatim:
      deadlines, retries, degrade and the fault hook, packed payloads.
    - Without one, in a ``torch.distributed`` world, the sync's collectives
      (the bucketed ``all_reduce`` plane over ``group``) are entered now, on
      this thread, and the worker waits on them. In one process the gather is
      the identity, as the JAX package's ``process_allgather`` is there.

    ``finish`` runs on the result on the worker, so its side effect (the
    watermark agreement's fold) lands even if nobody fences the handle; a
    ``finish`` that raises surfaces from ``result()``. ``attrs`` are extra
    attributes of the ``deferred.dispatch`` span (the lag-k ring stamps its
    depth there as ``lag_controller``, the deferred epoch sync its
    ``group``).
    """
    guard = guard if guard is not None else current_sync_guard()
    span_attrs = None
    if TRACE.enabled:
        span_attrs = {"plane": label}
        if attrs:
            span_attrs.update(attrs)
    with _span("deferred.dispatch", span_attrs):
        pending: Optional[StateSync] = None
        if gather_fn is None and dist_active():
            # the bucketed plane copies each bucket as it enters it, here
            pending = dispatch_state_sync(state, reductions, group=group, guard=guard, deferred=True, reissue=False)
        else:
            snapshot = snapshot_state(state)  # the worker reads it later

        def task() -> Any:
            task_attrs = {"plane": label} if TRACE.enabled else None
            with _span("deferred.complete", task_attrs):
                if pending is not None:
                    out = pending.finish()
                else:
                    out = host_gather(snapshot, reductions, gather_fn or _own_rank, guard=guard, reissue=False)
                if finish is not None:
                    out = finish(out)
            record_deferred("completed")
            return out

        future = _HOST_PLANE.submit(task)
    record_deferred("dispatched")
    return SyncHandle("host", future, watermark=watermark, label=label)


# -------------------------------------------------- the deferred bucketed plane
class DeferredSyncPlane:
    """A deferred bucketed sync bound once to its reductions and group:
    ``dispatch(state)`` per step enters the collectives and returns a handle.

    The JAX package's form resolves a compiled program once; the port has no
    program to cache, so this binds the arguments and keeps the hot loop's
    call short."""

    __slots__ = ("_reductions", "_group", "_layouts", "_device", "_finish", "_guard")

    def __init__(self, reductions: Dict[Any, ReduceFx], group: Optional[Any] = None,
                 layouts: Optional[Dict[Any, tuple]] = None, device: Optional[torch.device] = None,
                 finish: Optional[Callable[[Any], Any]] = None, guard: Optional[SyncGuard] = None) -> None:
        self._reductions, self._group, self._layouts = reductions, group, layouts
        self._device, self._finish, self._guard = device, finish, guard

    def dispatch(self, state: Dict[Any, Any], watermark: Optional[int] = None) -> SyncHandle:
        return deferred_sync_state(state, self._reductions, group=self._group, watermark=watermark,
                                   finish=self._finish, guard=self._guard, layouts=self._layouts,
                                   device=self._device)


def deferred_sync_state(
    state: Dict[Any, Any],
    reductions: Dict[Any, ReduceFx],
    group: Optional[Any] = None,
    watermark: Optional[int] = None,
    finish: Optional[Callable[[Any], Any]] = None,
    guard: Optional[SyncGuard] = None,
    layouts: Optional[Dict[Any, tuple]] = None,
    device: Optional[torch.device] = None,
    attrs: Optional[Dict[str, Any]] = None,
) -> SyncHandle:
    """Enter the bucketed sync of ``state`` over ``group`` without waiting;
    returns a ``"device"`` :class:`SyncHandle`.

    The same collectives as :func:`~metrics_tpu_torch.parallel.sync.
    all_reduce_state` (one ``all_reduce`` per (dtype, op) bucket, the gather
    plane for gather states), entered now on this thread as ``async_op=True``
    works on copies of the state; ``result()`` waits on them under ``guard``
    (captured now) and returns the synced dict (through ``finish``). Every
    rank resolves its handles at the same point of its program, so a
    corrupted payload that the guard retries at ``result()`` enters its
    collective again at the same point on every rank. Without a
    ``torch.distributed`` group the handle is ready with a copy of the state.
    ``attrs`` are extra attributes of the ``deferred.dispatch`` span.
    """
    if not state or not dist_active():
        out = snapshot_state(state)
        return SyncHandle("ready", finish(out) if finish is not None else out, watermark=watermark,
                          label="sync_state")
    guard = guard if guard is not None else current_sync_guard()
    span_attrs = None
    if TRACE.enabled:
        span_attrs = {"plane": "sync_state"}
        if attrs:
            span_attrs.update(attrs)
    with _span("deferred.dispatch", span_attrs):
        pending = dispatch_state_sync(state, reductions, group=group, layouts=layouts, device=device, guard=guard,
                                      deferred=True)
    record_deferred("dispatched")
    return SyncHandle("device", pending, finish=finish, watermark=watermark, label="sync_state")


def deferred_sparse_sync(
    plane: Any,
    state: Dict[str, Any],
    touched: Any = None,
    watermark: Optional[int] = None,
    label: str = "sparse_sync",
    attrs: Optional[Dict[str, Any]] = None,
) -> SyncHandle:
    """Run one sparse round in the background; returns a ``"host"``
    :class:`SyncHandle`.

    ``plane`` is a :class:`~metrics_tpu_torch.parallel.sparse.SparseSyncPlane`;
    the task is its round verbatim (the bitmap ``all_reduce``, the union read,
    the row exchange or the dense fallback, guard retries, chaos at site
    ``"sparse_sync"``, the round ledger) on the single-worker host plane, over
    the plane's own process groups (see the module docstring). ``state`` is
    copied now (the port's states are written in place), so the caller keeps
    accumulating; the ``touched`` hint too. ``attrs`` are extra attributes of
    the ``deferred.dispatch`` span.
    """
    span_attrs = None
    if TRACE.enabled:
        span_attrs = {"plane": label, "capacity": plane.capacity}
        if attrs:
            span_attrs.update(attrs)
    with _span("deferred.dispatch", span_attrs):
        topo = plane._twin_topology()
        snapshot = snapshot_state(state)
        hint = None if touched is None else torch.as_tensor(touched).clone()

        def task() -> Any:
            task_attrs = {"plane": label} if TRACE.enabled else None
            with _span("deferred.complete", task_attrs):
                with plane._lock:
                    out = plane._sync_locked(snapshot, hint, topo)
            record_deferred("completed")
            return out

        future = _HOST_PLANE.submit(task)
    plane._inflight = [f for f in plane._inflight if not f.done()] + [future]
    record_deferred("dispatched")
    return SyncHandle("host", future, watermark=watermark, label=label)
