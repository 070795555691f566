"""Fixed-capacity padded buffers: the fixed-shape form of "cat" states.

Counterpart of ``metrics_tpu/parallel/buffer.py``. A :class:`PaddedBuffer` is
a pre-allocated ``(capacity, *item)`` tensor plus an int64 0-d ``count`` on the
same device. Appends and merges write rows on the device with no host read:
``count`` keeps the true number of appended rows, and rows beyond
``capacity`` are dropped. What a host-side consumer does when it sees
``count > capacity`` is an explicit policy (:func:`handle_overflow`):

- ``"error"`` (default): raise :class:`~metrics_tpu_torch.utils.exceptions.BufferOverflowError`;
- ``"warn_drop"``: warn once per message and keep the capacity-truncated rows.

:func:`set_overflow_policy` sets the process-wide default; ``buffer_values``
and the host sync plane take a per-call override.
"""
from typing import Any, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.utils.data import dim_zero_cat, scatter_rows_drop
from metrics_tpu_torch.utils.exceptions import BufferOverflowError
from metrics_tpu_torch.utils.prints import rank_zero_warn_once

OVERFLOW_POLICIES = ("error", "warn_drop")

_OVERFLOW_POLICY = "error"


def set_overflow_policy(policy: str) -> str:
    """Set the process-wide PaddedBuffer overflow policy; returns the old one."""
    global _OVERFLOW_POLICY
    if policy not in OVERFLOW_POLICIES:
        raise ValueError(f"overflow policy must be one of {OVERFLOW_POLICIES}, got {policy!r}")
    old = _OVERFLOW_POLICY
    _OVERFLOW_POLICY = policy
    return old


def overflow_policy() -> str:
    """The process-wide PaddedBuffer overflow policy."""
    return _OVERFLOW_POLICY


def handle_overflow(name: str, count: int, capacity: int, policy: Optional[str] = None) -> None:
    """Apply the overflow policy to one observed ``(count, capacity)`` pair.

    No-op when ``count <= capacity``. ``policy=None`` uses the process-wide
    default. ``name`` labels the offending state in the error or warning.
    """
    if count <= capacity:
        return
    policy = policy if policy is not None else _OVERFLOW_POLICY
    if policy not in OVERFLOW_POLICIES:
        raise ValueError(f"overflow policy must be one of {OVERFLOW_POLICIES}, got {policy!r}")
    message = (
        f"PaddedBuffer state '{name}' overflowed: {count} rows appended into capacity "
        f"{capacity}; rows beyond capacity were dropped on device. Increase the metric's "
        "`capacity` argument."
    )
    if policy == "error":
        raise BufferOverflowError(message)
    rank_zero_warn_once(message, UserWarning)


class PaddedBuffer(NamedTuple):
    """A fixed-capacity append buffer. ``data``: (capacity, *item), ``count``: int64 0-d tensor."""

    data: Tensor
    count: Tensor

    @property
    def capacity(self) -> int:
        return self.data.shape[0]


def buffer_init(
    capacity: int, item_shape: Sequence[int] = (), dtype: torch.dtype = torch.float32, device: Optional[torch.device] = None
) -> PaddedBuffer:
    """An empty buffer with room for ``capacity`` rows of ``item_shape``."""
    return PaddedBuffer(
        data=torch.zeros((capacity, *item_shape), dtype=dtype, device=device),
        count=torch.zeros((), dtype=torch.int64, device=device),
    )


def _place(buf: PaddedBuffer, rows: Tensor, n_valid: Union[int, Tensor]) -> PaddedBuffer:
    """Write ``rows[:n_valid]`` after ``buf``'s valid rows, dropping what passes capacity."""
    j = torch.arange(rows.shape[0], device=rows.device)
    dest = torch.where(j < n_valid, buf.count + j, buf.capacity)
    return PaddedBuffer(data=scatter_rows_drop(buf.data, dest, rows), count=buf.count + n_valid)


def buffer_append(buf: PaddedBuffer, batch: Tensor) -> PaddedBuffer:
    """Append a ``(B, *item)`` batch. Rows that would land past ``capacity``
    are dropped; ``count`` still advances, so the overflow shows at compute."""
    batch = torch.atleast_1d(batch)
    return _place(buf, batch, batch.shape[0])


def buffer_merge(a: PaddedBuffer, b: PaddedBuffer) -> PaddedBuffer:
    """``b``'s valid rows after ``a``'s; the result keeps ``a``'s capacity."""
    return _place(a, b.data, b.count)


def buffer_compact_gathered(data: Tensor, counts: Tensor, capacity: Optional[int] = None) -> PaddedBuffer:
    """Compact a gathered ``(W, rows, *item)`` stack into one buffer of
    capacity ``W * capacity`` (``capacity`` defaults to ``rows``; a gather may
    send only the first ``rows <= capacity`` rows of each rank): every rank's
    valid rows go to the front in rank order, by an exclusive prefix sum over
    the capacity-clamped counts. ``count`` stays the unclamped sum, so an
    overflow on any rank still shows."""
    world, rows = data.shape[0], data.shape[1]
    cap = rows if capacity is None else capacity
    clamped = torch.clamp(counts, max=cap)
    offsets = torch.cumsum(clamped, 0) - clamped
    row = torch.arange(rows, device=data.device)
    valid = row[None, :] < clamped[:, None]
    dest = torch.where(valid, offsets[:, None] + row[None, :], world * cap)
    out = data.new_zeros((world * cap, *data.shape[2:]))
    out = scatter_rows_drop(out, dest.reshape(-1), data.reshape(world * rows, *data.shape[2:]))
    return PaddedBuffer(data=out, count=torch.sum(counts))


def buffer_all_gather(buf: PaddedBuffer, group: Optional[Any] = None) -> PaddedBuffer:
    """Gather every rank's buffer over ``group`` into one compacted buffer of
    capacity ``W * capacity``: every rank's valid rows at the front, in rank
    order, ``count`` the unclamped sum. Two ``all_gather`` calls (the data,
    the counts); with a :class:`~metrics_tpu_torch.parallel.placement.
    MeshHierarchy` as ``group``, each in two stages (across slices, then
    within the slice), in the same rank order. Outside a process group the
    world is this process."""
    from metrics_tpu_torch.parallel.sync import _gather_call, _resolve_hierarchy, _unguarded_plane, dist_active

    if not dist_active():
        return buffer_compact_gathered(buf.data.unsqueeze(0), buf.count.reshape(1))
    topo = _resolve_hierarchy(group)
    plane = _unguarded_plane("buffer_all_gather")  # unguarded, as the JAX package's in-jit gather
    data = _gather_call(plane, topo, buf.data.contiguous())
    counts = _gather_call(plane, topo, buf.count.reshape(1))
    return buffer_compact_gathered(torch.stack(data), torch.cat(counts))


def buffer_values(buf: PaddedBuffer, overflow: Optional[str] = None, name: str = "<buffer>") -> Tensor:
    """The valid rows as a dense tensor (one host read of ``count``).

    ``count > capacity`` goes through :func:`handle_overflow`: ``error``
    raises ``BufferOverflowError``, ``warn_drop`` warns once and returns the
    capacity-truncated rows.
    """
    count = int(buf.count)
    handle_overflow(name, count, buf.capacity, policy=overflow)
    return buf.data[: min(count, buf.capacity)]


def buffer_mask(buf: PaddedBuffer) -> Tensor:
    """Validity mask of shape ``(capacity,)``, computed on the device."""
    return torch.arange(buf.capacity, device=buf.data.device) < buf.count


BufferOrList = Union[PaddedBuffer, list, Tensor]


def as_values(state_value: BufferOrList) -> Tensor:
    """Dense values from a PaddedBuffer, a list of tensors, or a tensor (a synced state)."""
    if isinstance(state_value, PaddedBuffer):
        return buffer_values(state_value)
    if isinstance(state_value, (list, tuple)):
        return dim_zero_cat(list(state_value))
    return state_value


def masked_values(state_value: BufferOrList) -> Tuple[Tensor, Tensor]:
    """``(data, mask)`` from a PaddedBuffer with no host read; lists and tensors are all valid."""
    if isinstance(state_value, PaddedBuffer):
        return state_value.data, buffer_mask(state_value)
    vals = as_values(state_value)
    return vals, torch.ones(vals.shape[0], dtype=torch.bool, device=vals.device)
