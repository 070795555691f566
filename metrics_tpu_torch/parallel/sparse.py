"""Sparse delta sync: collective bytes in proportion to the rows a round
touched, not to the slab's K rows.

Counterpart of ``metrics_tpu/parallel/sparse.py``. The dense plane
(``parallel/sync.py``) moves every slab's full ``(K, *item)`` payload each
round. :class:`SparseSyncPlane` moves the rows that changed:

1. **Touched bitmap.** Each rank marks the rows its state changed since the
   last round (a compare against the plane's baseline, or an explicit
   ``touched=`` hint from :func:`~metrics_tpu_torch.parallel.slab.
   slab_touched_mask`). The ``(K,)`` mask packs into lanes of words
   (:func:`pack_touched`): a sum of the words counts each row's touches in its
   lane without a carry, since a lane holds ``world``. The JAX package's words
   are ``uint32``; the port keeps each word's 32 lane bits in an int64 word,
   value-equal, because ``torch.distributed`` sums int64 everywhere. One
   ``all_reduce`` a round carries the words, the int64 deltas of the dense
   residual leaves (a count-min tail) and one word that counts the ranks whose
   attempt failed.
2. **The union read.** One host read a round (the union's size and the
   failure count) decides the mode; it is the round's one synchronizing call.
   The union's ids are made on the device (a stable sort of the mask), in
   ascending order, as the JAX package's ``flatnonzero``.
3. **Fixed-capacity row exchange** (union within ``capacity``). Each rank
   sends one contiguous uint8 buffer: the int64 slot-id header, then each row
   leaf's ``capacity`` rows viewed as bytes (``sum`` rows carry current minus
   baseline, ``min`` / ``max`` rows the current rows). One
   ``all_gather_into_tensor`` moves it; the fold views the bytes back to each
   leaf's dtype and writes the union's rows of the merged view: a sum of the
   deltas, or a min / max.
4. **Dense fallback** (union beyond ``capacity``): the round runs the dense
   bucketed plane and counts it; a persistent overflow warns once, naming
   ``sparse_capacity``.
5. **Skip** (empty union): no row exchange; only the bitmap collective ran.

The staged collectives are 2 a round (flat) or 4 (a
:class:`~metrics_tpu_torch.parallel.placement.MeshHierarchy`: each stage over
``ici`` and ``dcn``), whatever K. A float dense residual adds an
``all_reduce`` of its own, as in the JAX package.

In-place state. The JAX package's baseline is a rebinding of immutable refs.
The port's states are written in place, so ``merged`` and ``baseline`` are
the plane's own tensors (two copies of the state: the plane's peak memory
above the slab), and a commit copies only the union's rows into them
(``index_copy_``). :meth:`SparseSyncPlane.sync` returns the plane's merged
tensors: read them, do not write them.

Fault tolerance. One round is one call at the chaos site ``"sparse_sync"``
under the :class:`~metrics_tpu_torch.parallel.sync.SyncGuard`: a drop, a stall
past the deadline or a corrupted payload retries the whole round, then
degrades (the local state, nothing committed) or raises. Ranks pair their
collectives by order, so every decision is one that all ranks share: a rank
whose attempt failed locally still enters the attempt's collectives and counts
itself in the bitmap collective's failure word, and every rank retries; an
injected corruption poisons what the rank sends, so every rank's fold and
vetting see it; the slot-id headers are compared across all gathered ranks,
the same on each. A wait has no deadline of its own (a rank cannot give up
alone on a round its peers complete). The header agreement and the
corruption vetting read the candidates on the host, so they run under the
guard's ``check_finite``; without it the round keeps its one synchronizing
call.
"""
import threading
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import Tensor

from metrics_tpu_torch.observability.counters import (
    record_collective,
    record_fault,
    record_gather_skip,
    record_sparse_fallback,
    record_sparse_round,
    record_sparse_skip,
)
from metrics_tpu_torch.parallel import sync as _sync
from metrics_tpu_torch.parallel.faults import _poison
from metrics_tpu_torch.parallel.placement import MeshHierarchy
from metrics_tpu_torch.parallel.sketch import is_sketch
from metrics_tpu_torch.parallel.sync import (
    StateSync,
    SyncGuard,
    _DeadlineExceeded,
    _gather_call,
    _payload_suspect,
    _reduce_call,
    _resolve_hierarchy,
    _run_hook,
    _Topology,
    _unguarded_plane,
    current_sync_guard,
    dist_active,
    snapshot_state,
)
from metrics_tpu_torch.utils.exceptions import InjectedFaultError, StateCorruptionError, SyncTimeoutError
from metrics_tpu_torch.utils.prints import rank_zero_warn_once

__all__ = ["SparseSyncPlane", "pack_touched", "touched_lane_bits", "unpack_touched_counts"]

_ROW_REDUCES = ("sum", "min", "max")
_SITE = "sparse_sync"


def touched_lane_bits(world: int) -> int:
    """Bitmap lane width (bits) for a ``world``-rank job: the smallest divisor
    of 32 with ``world < 2**bits``, so a lane holds every rank's touch."""
    if not (isinstance(world, int) and world >= 1):
        raise ValueError(f"`world` must be a positive int, got {world!r}")
    for bits in (1, 2, 4, 8, 16):
        if world < (1 << bits):
            return bits
    return 32


def _lanes(world: int) -> Tuple[int, int]:
    bits = touched_lane_bits(world)
    return bits, 32 // bits


def pack_touched(touched: Tensor, world: int) -> Tensor:
    """Pack a ``(K,)`` touched mask into int64 words of ``32 // bits`` lanes
    each, value-equal to the JAX package's ``uint32`` words. A rank's lane
    holds 0 or 1; the sum over ranks holds each row's touch count."""
    bits, rpw = _lanes(world)
    k = touched.shape[0]
    words = -(-k // rpw)
    t = torch.zeros(words * rpw, dtype=torch.int64, device=touched.device)
    t[:k] = touched.to(torch.int64)
    shifts = torch.ones(rpw, dtype=torch.int64, device=touched.device) << (bits * torch.arange(
        rpw, dtype=torch.int64, device=touched.device))
    return (t.view(words, rpw) * shifts).sum(dim=1)


def _unpack_counts(words: Tensor, num_rows: int, world: int) -> Tensor:
    bits, rpw = _lanes(world)
    shifts = bits * torch.arange(rpw, dtype=torch.int64, device=words.device)
    return ((words[:, None] >> shifts[None, :]) & ((1 << bits) - 1)).reshape(-1)[:num_rows]


def unpack_touched_counts(words: Any, num_rows: int, world: int) -> np.ndarray:
    """Host inverse of :func:`pack_touched` after the sum: per-row touch
    counts (``> 0`` is union membership)."""
    bits, rpw = _lanes(world)
    if isinstance(words, Tensor):
        words = words.detach().cpu().numpy()
    w = np.asarray(words).astype(np.int64)
    shifts = (bits * np.arange(rpw, dtype=np.int64))[None, :]
    return ((w[:, None] >> shifts) & ((1 << bits) - 1)).reshape(-1)[:num_rows]


def _payload_of(value: Any) -> Tensor:
    """The tensor a state leaf moves (a sketch moves its counts)."""
    return value.counts if is_sketch(value) else value


def _rewrap(template: Any, payload: Tensor) -> Any:
    return type(template)(payload) if is_sketch(template) else payload


def _fold_identity(dtype: torch.dtype, fx: str) -> Any:
    if dtype.is_floating_point:
        return float("inf") if fx == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if fx == "min" else info.min


def _aligned(nbytes: int) -> int:
    return -(-nbytes // 8) * 8


class _Attempt:
    """What one round attempt produced: its mode, union size, candidate
    payloads (in ``names`` order), the gathered headers and whether any
    rank's attempt failed."""

    __slots__ = ("mode", "rows", "names", "leaves", "failed", "header_ok", "ids")

    def __init__(self) -> None:
        self.mode, self.rows, self.names, self.leaves = "skip", 0, [], []
        self.failed, self.header_ok, self.ids = False, True, None


class SparseSyncPlane:
    """Stateful sparse delta-sync plane over a slab-shaped state dict.

    Holds two copies of the state between rounds: ``merged``, the cross-rank
    merged view (what the dense plane would give from the ranks' current
    states; what :meth:`sync` returns), and ``baseline``, the state as of the
    last accepted round (``current - baseline`` is what a round exchanges).

    Build it from the metric's reset state (``sum`` leaves zero, ``min`` /
    ``max`` leaves at their fill): there every rank's copy equals the merged
    view, which seeds the invariant ``merged == dense_sync(current)`` each
    round keeps. :meth:`rebase` seeds it again (epoch reset, restore).

    Leaves with leading dimension ``num_rows`` are row leaves (the slabs the
    exchange slices); the others are dense residuals (``sum`` only), delta-
    synced every round. ``row_leaves=`` names the row leaves explicitly.
    ``group`` is a process group, a :class:`~metrics_tpu_torch.parallel.
    placement.MeshHierarchy` or ``None`` (the default world; outside a process
    group, a world of this process); ``hierarchy=`` as in
    :func:`~metrics_tpu_torch.parallel.sync.all_reduce_state`.
    """

    def __init__(
        self,
        state: Dict[str, Any],
        reductions: Dict[str, Any],
        num_rows: int,
        group: Any = None,
        *,
        capacity: int = 64,
        row_leaves: Optional[Sequence[str]] = None,
        hierarchy: Any = None,
        guard: Optional[SyncGuard] = None,
        fallback_warn_fraction: float = 0.5,
        fallback_warn_rounds: int = 8,
    ) -> None:
        if not (isinstance(num_rows, int) and num_rows >= 1):
            raise ValueError(f"`num_rows` must be a positive int, got {num_rows!r}")
        if not (isinstance(capacity, int) and capacity >= 1):
            raise ValueError(f"`sparse_capacity` must be a positive int, got {capacity!r}")
        if not state:
            raise ValueError("SparseSyncPlane needs at least one state leaf")
        self._group, self._hierarchy, self._guard = group, hierarchy, guard
        self.num_rows, self.capacity = num_rows, capacity
        self.fallback_warn_fraction = float(fallback_warn_fraction)
        self.fallback_warn_rounds = int(fallback_warn_rounds)

        def leading(v: Any) -> Optional[int]:
            shape = tuple(_payload_of(v).shape)
            return shape[0] if shape else None

        if row_leaves is None:
            row_leaves = tuple(n for n, v in state.items() if leading(v) == num_rows)
        row_set = set(row_leaves)
        self._row_names: Tuple[str, ...] = tuple(n for n in state if n in row_set)
        self._dense_names: Tuple[str, ...] = tuple(n for n in state if n not in row_set)
        if not self._row_names:
            raise ValueError(
                f"no state leaf has leading dimension num_rows={num_rows}; the sparse plane needs at least one row"
                " slab (pass row_leaves= to name them explicitly)")
        self._reductions: Dict[str, Any] = {}
        self._row_reduce: Dict[str, str] = {}
        for n, v in state.items():
            fx = reductions[n]
            self._reductions[n] = fx
            if n in row_set:
                if leading(v) != num_rows:
                    raise ValueError(f"row leaf {n!r} has leading dimension {leading(v)}, expected num_rows={num_rows}")
                fx = "sum" if is_sketch(v) else fx
                if fx not in _ROW_REDUCES:
                    raise ValueError(
                        f"row leaf {n!r} has reduction {fx!r}; the sparse plane folds {_ROW_REDUCES} rows (slab"
                        " reductions) — use the dense plane for anything else")
                self._row_reduce[n] = fx
            elif not (is_sketch(v) or fx == "sum"):
                raise ValueError(
                    f"dense residual leaf {n!r} has reduction {fx!r}; only 'sum'-kind residuals (count-min tails,"
                    " counts leaves) delta-sync through the sparse plane — use the dense plane for anything else")
        self._merged = snapshot_state(state)
        self._baseline = snapshot_state(state)
        self.rounds = self.fallbacks = self.skips = 0
        self._warned_fallbacks = False
        self._lock = threading.Lock()
        self._twin: Optional[_Topology] = None  # the deferred rounds' own groups
        self._inflight: List[Any] = []

    # ------------------------------------------------------------- plumbing
    def _topology(self) -> Optional[_Topology]:
        """The topology of a round on the caller's thread (``None``: no process
        group, a world of one)."""
        return _resolve_hierarchy(self._group, self._hierarchy) if dist_active() else None

    def _twin_topology(self) -> Optional[_Topology]:
        """The topology of the rounds that run on the host plane's worker:
        groups of their own over the same ranks, since collectives that two
        threads enter on one group would lose their pairing. Made on every rank
        at the same point (the first deferred round), every group in the same
        order."""
        if self._twin is not None or not dist_active():
            return self._twin
        topo = _resolve_hierarchy(self._group, self._hierarchy)
        h = self._group if isinstance(self._group, MeshHierarchy) else self._hierarchy
        if isinstance(h, MeshHierarchy) and self._hierarchy is not False:
            grid = [list(g) for g in h.grid]
            ici, _ = dist.new_subgroups_by_enumeration(grid)
            dcn, _ = dist.new_subgroups_by_enumeration([[g[p] for g in grid] for p in range(h.per_slice)])
            twin = h._replace(ici=ici, dcn=dcn, world=None)
            self._twin = _Topology(ici, None, "ici") if h.slices == 1 else _Topology(None, twin, "world")
        else:
            ranks = None if topo.group is None else dist.get_process_group_ranks(topo.group)
            self._twin = _Topology(dist.new_group(ranks), None, topo.crossing)
        return self._twin

    def _world(self, topo: Optional[_Topology]) -> int:
        return 1 if topo is None else topo.world

    def rebase(self, state: Dict[str, Any], merged: Optional[Dict[str, Any]] = None) -> None:
        """Seed the baseline (and the merged view) again: the epoch-reset /
        restore hook. ``merged=None`` seeds the merged view from ``state``,
        valid for a reset-shaped state only (see the class docstring)."""
        self._drain()
        with self._lock:
            self._baseline = snapshot_state(state)
            self._merged = snapshot_state(merged if merged is not None else state)

    @property
    def merged(self) -> Dict[str, Any]:
        """The current merged view (what the last round returned)."""
        return dict(self._merged)

    def _drain(self) -> None:
        """Wait for this plane's deferred rounds: every rank runs its rounds in
        the order it submitted them."""
        while self._inflight:
            self._inflight.pop(0).exception()

    # ----------------------------------------------------------- the round
    def _attempt(self, current: Dict[str, Any], touched: Optional[Tensor], topo: Optional[_Topology],
                 failed_here: bool, corrupt: bool) -> _Attempt:
        """One round attempt. No plane state changes here, so a retry runs it
        again on the same inputs. Every rank enters the same collectives: the
        bitmap ``all_reduce``, then (by the shared union and failure count) the
        row gather, the dense plane, or nothing."""
        box = _Attempt()
        world = self._world(topo)
        first = _payload_of(current[self._row_names[0]])
        device, k = first.device, self.num_rows
        if touched is not None:
            mask = torch.as_tensor(touched, device=device).reshape(k).to(torch.bool)
        else:
            mask = torch.zeros(k, dtype=torch.bool, device=device)
            for n in self._row_names:
                diff = _payload_of(current[n]) != _payload_of(self._baseline[n])
                mask |= diff.reshape(k, -1).any(dim=1)
        words = pack_touched(mask, world)
        deltas = {n: _payload_of(current[n]) - _payload_of(self._baseline[n]) for n in self._dense_names}
        if corrupt:
            deltas = {n: _poison(d) for n, d in deltas.items()}
        riding = [n for n in self._dense_names if deltas[n].dtype == torch.int64]
        flag = torch.full((1,), int(failed_here), dtype=torch.int64, device=device)
        payload = torch.cat([words] + [deltas[n].reshape(-1) for n in riding] + [flag])
        summed = self._reduce(topo, payload)
        summed_deltas, offset = {}, words.shape[0]
        for n in riding:
            summed_deltas[n] = summed[offset: offset + deltas[n].numel()].view(deltas[n].shape)
            offset += deltas[n].numel()
        for n in self._dense_names:
            if n not in riding:  # a float residual: an all_reduce of its own
                summed_deltas[n] = self._reduce(topo, deltas[n].contiguous())
        union = _unpack_counts(summed[: words.shape[0]], k, world) > 0
        rows, failures = torch.stack([union.sum(), summed[-1]]).tolist()  # the round's one host read
        box.rows, box.failed = int(rows), failures > 0
        if box.failed:
            return box
        if box.rows == 0:
            box.mode, box.names = "skip", list(self._dense_names)
            box.leaves = [summed_deltas[n] for n in self._dense_names]
            return box
        box.names = list(self._row_names) + list(self._dense_names)
        if box.rows > self.capacity:
            box.mode = "fallback"
            dense = self._dense_sync(current, topo, corrupt)
            box.leaves = [_payload_of(dense[n]) for n in box.names]
            return box
        box.mode = "sparse"
        n_rows = box.rows
        ids = torch.argsort((~union).to(torch.uint8), stable=True)[:n_rows]
        box.ids = ids
        new_rows, box.header_ok = self._exchange(current, ids, topo, corrupt)
        box.leaves = [new_rows[n] for n in self._row_names] + [summed_deltas[n] for n in self._dense_names]
        return box

    def _reduce(self, topo: Optional[_Topology], payload: Tensor) -> Tensor:
        if topo is None:
            return payload
        return _reduce_call(_unguarded_plane(_SITE), topo, payload, "sum", resolve=True).result[0]

    def _dense_sync(self, current: Dict[str, Any], topo: Optional[_Topology], corrupt: bool) -> Dict[str, Any]:
        """The fallback: the dense bucketed plane over the whole state."""
        if corrupt:
            current = {n: _rewrap(v, _poison(_payload_of(v))) for n, v in current.items()}
        if topo is None:
            return snapshot_state(current)
        return StateSync(current, self._reductions, topo, {}, None, _unguarded_plane(_SITE), deferred=False).finish()

    def _exchange(self, current: Dict[str, Any], ids: Tensor, topo: Optional[_Topology],
                  corrupt: bool) -> Tuple[Dict[str, Tensor], Any]:
        """The fixed-capacity row exchange and its fold: every rank's header and
        rows in one uint8 buffer, one gather, the union's new merged rows."""
        cap, n_rows = self.capacity, ids.shape[0]
        device = ids.device
        header = torch.full((cap,), -1, dtype=torch.int64, device=device)
        header[:n_rows] = ids
        parts, layout, offset = [header.view(torch.uint8)], [], cap * 8
        for n in self._row_names:
            fx, value = self._row_reduce[n], _payload_of(current[n])
            rows = value.index_select(0, ids)
            if fx == "sum":
                rows = rows - _payload_of(self._baseline[n]).index_select(0, ids)
                block = torch.zeros((cap, *value.shape[1:]), dtype=value.dtype, device=device)
            else:
                block = torch.full((cap, *value.shape[1:]), _fold_identity(value.dtype, fx), dtype=value.dtype,
                                   device=device)
            block[:n_rows] = _poison(rows) if corrupt else rows
            raw = block.reshape(-1).view(torch.uint8)
            pad = _aligned(raw.numel()) - raw.numel()
            parts.append(raw if not pad else torch.cat([raw, raw.new_zeros(pad)]))
            layout.append((n, offset, raw.numel(), block.shape))
            offset += raw.numel() + pad
        payload = torch.cat(parts)
        stacked = self._gather(topo, payload)  # (world, bytes)
        headers = stacked[:, : cap * 8].contiguous().view(torch.int64)
        header_ok = (headers == headers[:1]).all()
        new_rows = {}
        for n, off, size, shape in layout:
            blocks = stacked[:, off: off + size].contiguous().view(self._dtype(n)).view(stacked.shape[0], *shape)
            lanes = blocks[:, :n_rows]
            prior = _payload_of(self._merged[n]).index_select(0, ids)
            fx = self._row_reduce[n]
            if fx == "sum":
                new_rows[n] = prior + lanes.sum(dim=0)
            elif fx == "min":
                new_rows[n] = torch.minimum(prior, lanes.amin(dim=0))
            else:
                new_rows[n] = torch.maximum(prior, lanes.amax(dim=0))
        return new_rows, header_ok

    def _dtype(self, name: str) -> torch.dtype:
        return _payload_of(self._merged[name]).dtype

    def _gather(self, topo: Optional[_Topology], payload: Tensor) -> Tensor:
        if topo is None:
            return payload.unsqueeze(0)
        if topo.hierarchy is not None:
            return torch.stack(_gather_call(_unguarded_plane(_SITE), topo, payload))
        world = topo.world
        out = payload.new_empty(world * payload.numel())
        record_collective("all_gather", payload, crossing=topo.crossing, fanout=world)
        gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
        gather_single(out, payload, group=topo.group)
        return out.view(world, payload.numel())

    def _corrupted(self, box: _Attempt) -> bool:
        """Corruption vetting of one attempt's candidates: a signature (NaN,
        saturated integers) the merged view before the round did not carry."""
        for n, leaf in zip(box.names, box.leaves):
            if _payload_suspect(_payload_of(self._merged[n])):
                continue  # a state saturated for real: never retry it forever
            if _payload_suspect(leaf):
                return True
        return False

    def sync(self, current: Dict[str, Any], touched: Optional[Tensor] = None) -> Dict[str, Any]:
        """Run one sparse round; returns the merged view: the plane's own
        tensors, which the next round updates in place (read them, or copy
        them, before it; never write them).

        ``current`` carries the construction-time schema. ``touched=`` is an
        optional ``(num_rows,)`` boolean hint (e.g. :func:`~metrics_tpu_torch.
        parallel.slab.slab_touched_mask` over the slot ids the step scattered)
        that skips the full-slab compare; it must cover every row that changed
        since the last round."""
        self._drain()
        with self._lock:
            return self._sync_locked(current, touched, self._topology())

    def _sync_locked(self, current: Dict[str, Any], touched: Optional[Tensor],
                     topo: Optional[_Topology]) -> Dict[str, Any]:
        guard = self._guard if self._guard is not None else current_sync_guard()
        hook = _sync._FAULT_HOOK
        idx = hook.note_call(_SITE) if hook is not None else self.rounds
        attempt = 0
        while True:
            err: Optional[Exception] = None
            corrupt = False
            if hook is not None:
                try:
                    _run_hook(hook, _SITE, idx, attempt, guard.deadline_s)
                except (InjectedFaultError, _DeadlineExceeded) as failure:
                    err = failure
                probe = torch.zeros(())
                corrupt = hook.after_call(_SITE, idx, attempt, [probe])[0] is not probe
            box = self._attempt(current, touched, topo, err is not None, corrupt)
            if box.failed:
                err = err or InjectedFaultError(f"a peer's attempt {attempt} of sparse-sync round {idx} failed")
            elif guard.check_finite and not (bool(box.header_ok) and not self._corrupted(box)):
                err = StateCorruptionError(f"corruption signature in sparse-sync round {idx} payload")
            else:
                break
            attempt += 1
            record_fault("sync_retries")
            if attempt <= guard.max_retries:
                time.sleep(guard.backoff_s * (2 ** (attempt - 1)))
                continue
            record_fault("sync_deadline_exceeded")
            if guard.policy == "degrade":
                # the local view for this round: merged and baseline stay, so the
                # next round offers the same deltas again
                record_fault("degraded_computes")
                return dict(current)
            if isinstance(err, StateCorruptionError):
                raise err
            raise SyncTimeoutError(f"sparse-sync round {idx} failed after {guard.max_retries} retries (deadline"
                                   f" {guard.deadline_s}s, policy 'raise'): {err}") from err
        return self._commit(current, box)

    def _commit(self, current: Dict[str, Any], box: _Attempt) -> Dict[str, Any]:
        self.rounds += 1
        record_sparse_round(box.rows)
        folded = dict(zip(box.names, box.leaves))
        if box.mode == "skip":
            self.skips += 1
            record_sparse_skip()
            record_gather_skip()
        elif box.mode == "fallback":
            self.fallbacks += 1
            record_sparse_fallback()
            for n in self._row_names:
                self._merged[n] = _rewrap(self._merged[n], folded[n])
                _payload_of(self._baseline[n]).copy_(_payload_of(current[n]))
            self._maybe_warn_fallbacks()
        else:
            for n in self._row_names:
                _payload_of(self._merged[n]).index_copy_(0, box.ids, folded[n])
                base = _payload_of(self._baseline[n])
                base.index_copy_(0, box.ids, _payload_of(current[n]).index_select(0, box.ids))
        for n in self._dense_names:
            if box.mode == "fallback":
                self._merged[n] = _rewrap(self._merged[n], folded[n])
            else:
                _payload_of(self._merged[n]).add_(folded[n])
            _payload_of(self._baseline[n]).copy_(_payload_of(current[n]))
        return dict(self._merged)

    def _maybe_warn_fallbacks(self) -> None:
        if self._warned_fallbacks or self.rounds < self.fallback_warn_rounds:
            return
        if self.fallbacks / self.rounds <= self.fallback_warn_fraction:
            return
        # one advisory a plane: the message carries the live counts, so the
        # process-wide dedup by text alone would fire again on every round
        self._warned_fallbacks = True
        rank_zero_warn_once(
            f"SparseSyncPlane fell back to the dense plane on {self.fallbacks}/{self.rounds} rounds (union exceeded"
            f" sparse_capacity={self.capacity}); the sparse exchange is not paying for its bitmap psum at this touch"
            " rate — raise sparse_capacity= (or sync on the dense plane) to fix.")

    def sync_deferred(self, current: Dict[str, Any], touched: Optional[Tensor] = None,
                      watermark: Optional[int] = None) -> Any:
        """Run one round on the deferred host plane; returns a
        :class:`~metrics_tpu_torch.parallel.deferred.SyncHandle`. Delegates to
        :func:`~metrics_tpu_torch.parallel.deferred.deferred_sparse_sync`."""
        from metrics_tpu_torch.parallel.deferred import deferred_sparse_sync

        return deferred_sparse_sync(self, current, touched, watermark=watermark)

    def __repr__(self) -> str:
        return (f"SparseSyncPlane(rows={self.num_rows}, capacity={self.capacity},"
                f" leaves={len(self._row_names)}+{len(self._dense_names)}, rounds={self.rounds},"
                f" fallbacks={self.fallbacks}, skips={self.skips})")
