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
"""
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch import Tensor

from metrics_tpu_torch.parallel.buffer import PaddedBuffer, buffer_compact_gathered, buffer_merge, handle_overflow
from metrics_tpu_torch.parallel.sketch import is_sketch, sketch_merge
from metrics_tpu_torch.utils.data import dim_zero_cat, dim_zero_max, dim_zero_mean, dim_zero_min, dim_zero_sum

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


def _gather_states(
    state: Dict[str, Any], names: List[str], layouts: Dict[str, tuple], device: torch.device, group: Optional[Any]
) -> Dict[str, Any]:
    """Gather the named states across ranks: one layout all_gather, then one padded all_gather per dtype."""
    world = dist.get_world_size(group)
    units, rows = [], []
    for name in names:
        data, row = _local_unit(state[name], layouts.get(name))
        units.append(data)
        rows.append(row)
    table = torch.tensor(rows, dtype=torch.int64, device=device)
    for u, name in enumerate(names):
        if isinstance(state[name], PaddedBuffer):  # the count stays on the device: no host read
            table[u, 3] = state[name].count
    gathered_tables = [torch.empty_like(table) for _ in range(world)]
    dist.all_gather(gathered_tables, table, group=group)
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
        gathered = [torch.empty_like(flat) for _ in range(world)]
        dist.all_gather(gathered, flat, group=group)
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


def _tensor_of(value: Any) -> Tensor:
    """The tensor a reduce state syncs: a sketch's counts, or the state itself."""
    return value.counts if is_sketch(value) else value


def all_reduce_state(
    state: Dict[str, Any],
    reductions: Dict[str, ReduceFx],
    group: Optional[Any] = None,
    layouts: Optional[Dict[str, tuple]] = None,
    device: Optional[torch.device] = None,
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
    """
    buckets: Dict[tuple, List[str]] = {}
    gather_names: List[str] = []
    for name, value in state.items():
        fx = reductions[name]
        if _is_gather_state(value, fx):
            gather_names.append(name)
        else:
            buckets.setdefault((_tensor_of(value).dtype, _REDUCE_OPS[fx]), []).append(name)

    ops = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN, "max": dist.ReduceOp.MAX}
    out = dict(state)
    world = None
    for (_dtype, op), names in buckets.items():
        flat = torch.cat([_tensor_of(state[n]).reshape(-1) for n in names])
        dist.all_reduce(flat, op=ops[op], group=group)
        offset = 0
        for n in names:
            v = _tensor_of(state[n])
            piece = flat[offset: offset + v.numel()].view(v.shape)
            offset += v.numel()
            if is_sketch(state[n]):
                out[n] = type(state[n])(piece)
                continue
            if reductions[n] == "mean":
                if world is None:
                    world = dist.get_world_size(group)
                piece = piece / world
            out[n] = piece

    if gather_names:
        if device is None:
            device = next((v.device for v in state.values() if isinstance(v, Tensor)), torch.device("cpu"))
        gathered = _gather_states(state, gather_names, layouts or {}, device, group)
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


def host_gather(
    state: Dict[str, Any],
    reductions: Dict[str, ReduceFx],
    gather_fn: Callable[[Tensor], List[Tensor]],
) -> Dict[str, Any]:
    """Gather-then-reduce sync through a caller-supplied ``gather_fn``: every
    tensor is gathered, stacked (list states are flattened element-major) and
    reduced per state, as ``metrics_tpu.parallel.sync.host_gather`` does. A
    PaddedBuffer gathers its data and count and comes back as the dense
    concatenation of every rank's valid rows; each rank's count goes through
    the overflow policy."""
    out: Dict[str, Any] = {}
    for name, value in state.items():
        fx = reductions[name]
        if isinstance(value, PaddedBuffer):
            datas, counts = gather_fn(value.data), gather_fn(value.count)
            for g, c in zip(datas, counts):
                handle_overflow(name, int(c), g.shape[0])
            parts = [g[: int(c)] for g, c in zip(datas, counts)]
            out[name] = dim_zero_cat(parts) if parts else value.data[:0]
            continue
        if is_sketch(value):
            out[name] = type(value)(stacked_reduction(fx)(torch.stack(list(gather_fn(value.counts)))))
            continue
        if isinstance(value, list):
            flat = [g for elem in value for g in gather_fn(elem)]
            reduction = stacked_reduction(fx)
            out[name] = reduction(flat) if reduction is not None else flat
            continue
        stacked = torch.stack(list(gather_fn(value)))
        reduction = stacked_reduction(fx)
        out[name] = reduction(stacked) if reduction is not None else stacked
    return out
