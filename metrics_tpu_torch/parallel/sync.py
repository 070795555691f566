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

Cat (list) states and stack (``None``) states accumulate and compute locally;
their cross-rank form, an ``all_gather`` of uneven sizes, is not ported yet
and raises ``NotImplementedError`` from :func:`all_reduce_state`.
"""
from typing import Any, Callable, Dict, List, Optional, Union

import torch
import torch.distributed as dist
from torch import Tensor

from metrics_tpu_torch.utils.data import dim_zero_cat, dim_zero_max, dim_zero_mean, dim_zero_min, dim_zero_sum

# A reduction spec as accepted by ``Metric.add_state``.
ReduceFx = Union[str, Callable, None]

_STR_REDUCTIONS = ("sum", "mean", "cat", "min", "max")
_REDUCE_OPS = {"sum": "sum", "mean": "sum", "min": "min", "max": "max"}


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
    if isinstance(acc, list):
        return acc + list(delta)
    if fx == "sum":
        return acc + delta
    if fx == "min":
        return torch.minimum(acc, delta)
    if fx == "max":
        return torch.maximum(acc, delta)
    raise ValueError(f"Reduction {fx!r} has no pairwise merge; metric must use the double-update forward.")


def is_mergeable(fx: ReduceFx, default: Any) -> bool:
    """Whether a state with this reduction supports pairwise merge (one-delta forward)."""
    if isinstance(default, list) or fx == "cat":
        return True
    return fx in ("sum", "min", "max")


def dist_active() -> bool:
    """Whether a ``torch.distributed`` process group is initialized. The port
    syncs whenever one is, even at world size 1."""
    return dist.is_available() and dist.is_initialized()


def all_reduce_state(
    state: Dict[str, Any], reductions: Dict[str, ReduceFx], group: Optional[Any] = None
) -> Dict[str, Any]:
    """Sync a state dict with one ``all_reduce`` per (dtype, op) bucket.

    Returns a new dict; the input tensors are not modified.
    """
    buckets: Dict[tuple, List[str]] = {}
    for name, value in state.items():
        fx = reductions[name]
        if isinstance(value, list) or fx not in _REDUCE_OPS:
            raise NotImplementedError(
                f"state {name!r} (dist_reduce_fx={fx!r}) needs a cross-rank all_gather of uneven sizes,"
                " which metrics_tpu_torch does not port yet; sum/mean/min/max states sync."
            )
        buckets.setdefault((value.dtype, _REDUCE_OPS[fx]), []).append(name)

    ops = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}
    out = dict(state)
    world = None
    for (_dtype, op), names in buckets.items():
        flat = torch.cat([state[n].reshape(-1) for n in names])
        dist.all_reduce(flat, op=ops[op], group=group)
        offset = 0
        for n in names:
            v = state[n]
            piece = flat[offset: offset + v.numel()].view(v.shape)
            offset += v.numel()
            if reductions[n] == "mean":
                if world is None:
                    world = dist.get_world_size(group)
                piece = piece / world
            out[n] = piece
    return out


def host_gather(
    state: Dict[str, Any], reductions: Dict[str, ReduceFx], gather_fn: Callable[[Tensor], List[Tensor]]
) -> Dict[str, Any]:
    """Gather-then-reduce sync through a caller-supplied ``gather_fn``: every
    array is gathered, stacked (list states are flattened element-major) and
    reduced per state, as ``metrics_tpu.parallel.sync.host_gather`` does."""
    out: Dict[str, Any] = {}
    for name, value in state.items():
        fx = reductions[name]
        if isinstance(value, list):
            flat = [g for elem in value for g in gather_fn(elem)]
            reduction = stacked_reduction(fx)
            out[name] = reduction(flat) if reduction is not None else flat
            continue
        stacked = torch.stack(list(gather_fn(value)))
        reduction = stacked_reduction(fx)
        out[name] = reduction(stacked) if reduction is not None else stacked
    return out
