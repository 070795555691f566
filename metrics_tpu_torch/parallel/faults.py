"""Chaos harness: seeded, scenario-addressable fault injection for the sync planes.

Counterpart of ``metrics_tpu/parallel/faults.py``. A :class:`ChaosInjector`
holds a seeded schedule of :class:`FaultSpec` s and installs itself as the
fault hook of ``parallel/sync.py``; every guarded collective call then
consults it. The gather-plane kinds:

- ``stall``: the call sleeps ``duration_s`` before it enters its collective;
  the guard's deadline must detect it (the guard sleeps at most its deadline,
  on the caller's thread: the stall burns one attempt, and a retry after the
  stall is consumed succeeds). A stall ends early when the injector is
  uninstalled.
- ``drop``: the call raises :class:`~metrics_tpu_torch.utils.exceptions.
  InjectedFaultError` before it enters its collective (a rank that dropped
  out). Retryable; ``times`` is how many consecutive attempts fail.
- ``corrupt``: the collective's result comes back poisoned (floats NaN,
  integers at their dtype's maximum), which the guard's ``check_finite`` scan
  detects and retries.
- ``preempt``: raises :class:`~metrics_tpu_torch.utils.exceptions.
  PreemptionError`, never retried: the caller checkpoints, restores and
  replays through the epoch watermark (``Metric.guarded_update``).

The serving-plane kinds (``ingest_stall``, ``clock_skew``, ``late_burst``,
and ``preempt`` at a service site) are consumed through
:meth:`ChaosInjector.ingest_faults`, which returns the specs that fire and
leaves their semantics to the caller. ``shard=`` and ``rank=`` address one
fleet shard or one stream rank.

Faults address a call by its site-relative index (``call=``, counted from
the injector's install) or fire at a ``rate=`` from the injector's seeded
``random.Random``; a rate verdict is drawn once per (spec, site, call, shard,
rank) and cached, so a retry of the same call sees the same verdict. The
verdict stream is host ``random``, so the same schedule and seed give the
JAX package's verdict sequence bit for bit. Where the port's sync numbers its
calls is documented in ``parallel/sync.py``.

:func:`corrupt_pytree` poisons the float leaves of a state dict before it
enters a sync (NaN propagates through the ``all_reduce`` and gather planes,
and :func:`~metrics_tpu_torch.core.metric.nonfinite_count` finds it after).
"""
import random
import threading
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import torch
from torch import Tensor

from metrics_tpu_torch.parallel.buffer import PaddedBuffer
from metrics_tpu_torch.parallel.sketch import is_sketch
from metrics_tpu_torch.utils.exceptions import InjectedFaultError, PreemptionError

__all__ = [
    "ChaosInjector",
    "FaultSpec",
    "chaos",
    "corrupt_pytree",
    "current_injector",
]

FAULT_KINDS = ("stall", "drop", "corrupt", "preempt", "ingest_stall", "clock_skew", "late_burst")

# the kinds ingest_faults() surfaces to the serving loop (preempt doubles as
# the mid-window kill when addressed at a service site)
SERVICE_FAULT_KINDS = ("ingest_stall", "clock_skew", "late_burst", "preempt")


class FaultSpec(NamedTuple):
    """One addressable fault in a chaos schedule.

    ``call`` pins the site-relative call index the fault fires on (``None``:
    fire at ``rate`` per call from the injector's seeded RNG). ``times`` is
    how many consecutive attempts of that call are affected: a transient
    fault (``times <= max_retries``) is recovered, a persistent one exhausts
    the budget into raise or degrade.
    """

    kind: str  # one of FAULT_KINDS
    call: Optional[int] = None
    times: int = 1
    duration_s: float = 0.0  # stall / ingest_stall length
    rate: float = 0.0  # per-call probability when call is None
    site: str = "host_gather"
    skew_s: float = 0.0  # clock_skew shift (late_burst shifts by -skew_s)
    shard: Optional[int] = None  # fleet shard index (None = every shard)
    rank: Optional[int] = None  # stream rank index (None = every rank)


class ChaosInjector:
    """Seeded fault injector; install it as the sync-plane hook with ``with``
    (or ``install()`` / ``uninstall()``).

    Thread-safe. ``calls`` counts the calls seen per site and ``injected``
    the faults fired per kind: the assertion surface of chaos tests.
    """

    def __init__(self, schedule: Sequence[FaultSpec], seed: int = 0):
        for spec in schedule:
            if spec.kind not in FAULT_KINDS:
                raise ValueError(f"unknown fault kind {spec.kind!r}; expected one of {FAULT_KINDS}")
            if spec.call is None and spec.rate <= 0.0 and spec.kind != "preempt":
                raise ValueError(f"spec {spec!r} is unaddressed: set call= or rate>0")
            if spec.shard is not None and not (isinstance(spec.shard, int) and spec.shard >= 0):
                raise ValueError(f"spec {spec!r}: shard= must be a non-negative int or None")
            if spec.rank is not None and not (isinstance(spec.rank, int) and spec.rank >= 0):
                raise ValueError(f"spec {spec!r}: rank= must be a non-negative int or None")
        self.schedule: List[FaultSpec] = list(schedule)
        self.seed = seed
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.calls: Dict[str, int] = {}
        self.injected: Dict[str, int] = {k: 0 for k in FAULT_KINDS}
        # a rate verdict is drawn once per (spec, call): a retry of the same
        # call sees the same verdict
        self._rate_verdicts: Dict[tuple, bool] = {}
        self._released = threading.Event()  # set by uninstall: cuts a stall short

    # ------------------------------------------------------------- matching
    def _matches(self, spec: FaultSpec, site: str, idx: int,
                 shard: Optional[int] = None, rank: Optional[int] = None) -> bool:
        if spec.site != site:
            return False
        if spec.call is not None:
            return spec.call == idx
        key = (id(spec), site, idx, shard, rank)
        verdict = self._rate_verdicts.get(key)
        if verdict is None:
            verdict = self._rate_verdicts[key] = self._rng.random() < spec.rate
        return verdict

    def verdict(self, spec: FaultSpec, site: str, idx: int) -> bool:
        """Whether ``spec`` fires on call ``idx`` at ``site``: thread-safe and
        stable (a rate verdict is drawn once and cached)."""
        with self._lock:
            return self._matches(spec, site, idx)

    # ------------------------------------------------------- hook interface
    def note_call(self, site: str) -> int:
        """The next site-relative call index (the guard calls this once per
        logical collective call, before any attempt)."""
        with self._lock:
            idx = self.calls.get(site, 0)
            self.calls[site] = idx + 1
        return idx

    def before_call(self, site: str, idx: int, attempt: int) -> None:
        """Runs before attempt ``attempt`` of call ``idx`` enters its
        collective: may sleep (stall), raise ``InjectedFaultError`` (drop) or
        raise ``PreemptionError`` (preempt)."""
        self.stall(self.stall_for(site, idx, attempt))

    def stall_for(self, site: str, idx: int, attempt: int) -> float:
        """``before_call`` without the sleep: raises as it does, and returns the
        seconds the attempt stalls (0.0: none), so that the guard can sleep at
        most its deadline on the caller's thread."""
        with self._lock:
            for spec in self.schedule:
                if not self._matches(spec, site, idx) or attempt >= spec.times:
                    continue
                if spec.kind == "preempt":
                    self.injected["preempt"] += 1
                    raise PreemptionError(f"injected preemption at {site} call {idx} (attempt {attempt})")
                if spec.kind == "drop":
                    self.injected["drop"] += 1
                    raise InjectedFaultError(
                        f"injected dropped participation at {site} call {idx} (attempt {attempt})")
                if spec.kind == "stall":
                    self.injected["stall"] += 1
                    return spec.duration_s
        return 0.0

    def stall(self, seconds: float) -> None:
        """Sleep ``seconds`` outside the lock (a stall must not block peers),
        cut short when the injector is uninstalled."""
        if seconds > 0:
            self._released.wait(seconds)

    def ingest_faults(self, site: str, idx: int, shard: Optional[int] = None,
                      rank: Optional[int] = None) -> List[FaultSpec]:
        """The service-plane specs that fire on ingest call ``idx`` at ``site``.
        There are no retries at ingest, so ``times`` means consecutive calls
        here: a call-pinned spec fires on calls ``call .. call + times - 1``.
        Fired kinds count into ``injected``."""
        fired: List[FaultSpec] = []
        with self._lock:
            for spec in self.schedule:
                if not self._service_addressed(spec, site, idx, shard, rank):
                    continue
                self.injected[spec.kind] += 1
                fired.append(spec)
        return fired

    def ingest_addressed(self, site: str, idx: int, shard: Optional[int] = None,
                         rank: Optional[int] = None) -> bool:
        """Whether any service-plane spec would fire on ingest call ``idx``;
        fires nothing (a rate verdict drawn here is the one a later
        ``ingest_faults`` at the same ``idx`` sees)."""
        with self._lock:
            return any(self._service_addressed(spec, site, idx, shard, rank) for spec in self.schedule)

    def _service_addressed(self, spec: FaultSpec, site: str, idx: int, shard: Optional[int],
                           rank: Optional[int]) -> bool:
        if spec.kind not in SERVICE_FAULT_KINDS or spec.site != site:
            return False
        if (spec.shard is not None and spec.shard != shard) or (spec.rank is not None and spec.rank != rank):
            return False
        if spec.call is not None:
            return spec.call <= idx < spec.call + spec.times
        return self._matches(spec, site, idx, shard, rank)

    def after_call(self, site: str, idx: int, attempt: int, result: Any) -> Any:
        """Runs on a collective's result (a list of tensors); may poison it."""
        with self._lock:
            corrupt = any(spec.kind == "corrupt" and self._matches(spec, site, idx) and attempt < spec.times
                          for spec in self.schedule)
            if corrupt:
                self.injected["corrupt"] += 1
        if not corrupt:
            return result
        return [_poison(t) for t in result]

    # ----------------------------------------------------------- lifecycle
    def install(self) -> "ChaosInjector":
        from metrics_tpu_torch.parallel import sync as _sync

        if _sync._FAULT_HOOK is not None and _sync._FAULT_HOOK is not self:
            raise RuntimeError("another ChaosInjector is already installed")
        self._released.clear()
        _sync._FAULT_HOOK = self
        return self

    def uninstall(self) -> None:
        from metrics_tpu_torch.parallel import sync as _sync

        if _sync._FAULT_HOOK is self:
            _sync._FAULT_HOOK = None
        self._released.set()

    def __enter__(self) -> "ChaosInjector":
        return self.install()

    def __exit__(self, *exc: Any) -> bool:
        self.uninstall()
        return False


def _poison(value: Any) -> Any:
    """One poisoned payload: floats NaN-filled, integers filled with their
    dtype's maximum (saturated garbage, what the guard's scan flags); other
    dtypes (bool) pass through."""
    if not isinstance(value, Tensor):
        return value
    if value.is_floating_point() or value.is_complex():
        return torch.full_like(value, float("nan"))
    if value.dtype != torch.bool:
        return torch.full_like(value, torch.iinfo(value.dtype).max)
    return value


def current_injector() -> Optional[ChaosInjector]:
    """The installed injector, if any."""
    from metrics_tpu_torch.parallel import sync as _sync

    hook = _sync._FAULT_HOOK
    return hook if isinstance(hook, ChaosInjector) else None


def chaos(*specs: FaultSpec, seed: int = 0) -> ChaosInjector:
    """Sugar: ``with chaos(FaultSpec(...), FaultSpec(...)) as inj: ...``."""
    return ChaosInjector(specs, seed=seed)


def corrupt_pytree(state: Any, seed: int = 0, fraction: float = 1.0) -> Any:
    """NaN-poison the float leaves of a state (a dict of tensors, lists,
    PaddedBuffers or sketches); integer leaves pass through. ``fraction``
    poisons that share of each float leaf's leading elements; ``seed`` is kept
    for the JAX package's signature. Returns new tensors: the input is left
    as it is."""
    del seed  # deterministic either way

    def poison(leaf: Any) -> Any:
        if isinstance(leaf, dict):
            return {k: poison(v) for k, v in leaf.items()}
        if isinstance(leaf, list):
            return [poison(v) for v in leaf]
        if isinstance(leaf, PaddedBuffer):
            return PaddedBuffer(poison(leaf.data), leaf.count)
        if is_sketch(leaf):
            return leaf  # integer counts by construction
        if not isinstance(leaf, Tensor) or not leaf.is_floating_point():
            return leaf
        if fraction >= 1.0 or leaf.numel() == 0:
            return torch.full_like(leaf, float("nan"))
        flat = leaf.reshape(-1).clone()
        flat[: max(1, int(flat.numel() * fraction))] = float("nan")
        return flat.view(leaf.shape)

    return poison(state)
