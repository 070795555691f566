"""The two-level topology of a job: slices of ranks joined by a fast link,
slices joined to each other by a slow one.

Counterpart of the hierarchy half of ``metrics_tpu/parallel/placement.py``
(``MeshHierarchy``, ``hierarchical_mesh``, ``HostHierarchy``,
``host_hierarchy``). The JAX package names two axes of a device mesh; the port
has no mesh, so a :class:`MeshHierarchy` holds two ``torch.distributed``
process groups:

- ``ici``: the ranks of the caller's slice (the fast, intra-node link);
- ``dcn``: the ranks at the caller's position in every slice (the slow,
  cross-node link).

World order is slice-major, as in the JAX package: ``grid[s][p]`` is the rank
at position ``p`` of slice ``s``. The sync planes (``parallel/sync.py``,
``parallel/sparse.py``) stage a sum over ``ici`` first and cross ``dcn`` with
the slice's result only, and a gather over ``dcn`` first and ``ici`` after.

Process groups are created collectively: every rank must create every
subgroup, in the same order, even the ones it does not belong to.
:func:`hierarchical_mesh` builds all ``ici`` groups, then all ``dcn`` groups,
in slice order, on every rank; build a hierarchy once and reuse it, not once a
sync. A hierarchy spans the default world.

The placement policies are the other half of the JAX module, in the form an
SPMD port takes. The JAX package places one global state over a mesh; here
every rank holds its own state, so a policy says what a rank keeps of it and
which process groups its sync and compute run over:

- :func:`row_sharded` keeps a ``PaddedBuffer`` epoch state row-sharded: each
  rank's buffer holds ``capacity // world`` rows (the JAX package's
  per-device block), and ``compute()`` runs the exact ring / ``all_to_all``
  engines of ``parallel/sharded_epoch.py`` over the group instead of
  gathering the epoch (``parallel/sharded_dispatch.py``);
- :func:`class_sharded` is the manual-SPMD form of a 2-D (dp x mp) layout
  over a :class:`MeshHierarchy` (``ici`` the mp group, ``dcn`` the dp group):
  a rank computes the full delta from its data, the sum-sync runs over dp on
  its own class block only, and the synced blocks are gathered over mp;
- :func:`batch_sharded` keeps this rank's block of a replicated global batch.

A policy is a callable ``(name, value) -> target`` that
``Metric.device_put`` resolves state by state: ``None`` (the state stays as
it is: replicated), a ``torch.device``, a :class:`RowBlock` or a
:class:`ClassBlock`.
"""
import os
import socket
from typing import Any, Callable, Collection, List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch import Tensor

__all__ = [
    "ClassBlock", "HostHierarchy", "MeshHierarchy", "RowBlock", "batch_sharded", "class_sharded", "hierarchical_mesh",
    "host_hierarchy", "row_sharded", "slice_grid",
]


class MeshHierarchy(NamedTuple):
    """The two process groups of a two-level topology, seen from one rank.

    ``ici`` spans the caller's slice, ``dcn`` the caller's position across
    slices, ``world`` the whole span (``None``: the default group).
    ``grid[s][p]`` is the global rank at position ``p`` of slice ``s``.
    """

    ici: Any
    dcn: Any
    slices: int
    per_slice: int
    grid: Tuple[Tuple[int, ...], ...]
    world: Any = None

    @property
    def size(self) -> int:
        return self.slices * self.per_slice


def _ragged(sizes: List[int]) -> ValueError:
    return ValueError(f"hierarchical_mesh: ragged slices {sizes}; the 2-level mesh needs every slice to hold the"
                      " same device count")


def slice_grid(world: int, slices: Optional[int] = None, slice_ids: Optional[Sequence[Any]] = None
               ) -> List[List[int]]:
    """Ranks ``0 .. world - 1`` grouped into equal slices, slice-major: by an
    explicit ``slices`` count (contiguous ranks), or by ``slice_ids[r]`` (one
    id a rank, such as its host name; slices in sorted id order, as the JAX
    package orders ``slice_index``).
    Ragged slices raise ``ValueError``, as the JAX package's mesh does."""
    if slices is not None:
        if slices <= 0 or world % slices:
            raise ValueError(f"hierarchical_mesh: {world} devices do not split into {slices} equal slices")
        per = world // slices
        return [list(range(s * per, (s + 1) * per)) for s in range(slices)]
    ids = list(slice_ids) if slice_ids is not None else [0] * world
    if len(ids) != world:
        raise ValueError(f"hierarchical_mesh: got {len(ids)} slice ids for {world} ranks")
    groups = [[r for r, i in enumerate(ids) if i == sid] for sid in sorted(set(ids))]
    if any(len(g) != len(groups[0]) for g in groups):
        raise _ragged([len(g) for g in groups])
    return groups


def _node_ids(world: int) -> List[Any]:
    """One node id a rank: contiguous blocks of ``LOCAL_WORLD_SIZE`` ranks
    (what ``torchrun`` assigns), else every rank's host name, gathered."""
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local is not None and int(local) > 0 and world % int(local) == 0:
        return [r // int(local) for r in range(world)]
    names: List[Any] = [None] * world
    dist.all_gather_object(names, socket.gethostname())
    return names


def hierarchical_mesh(slices: Optional[int] = None) -> MeshHierarchy:
    """Build the :class:`MeshHierarchy` of the running job over the default
    world, on every rank at the same point of the program.

    Ranks are grouped by an explicit ``slices`` count, else by node
    (``LOCAL_WORLD_SIZE``, else the host names through one
    ``all_gather_object``). Ragged slices raise ``ValueError``. Outside a
    process group it is a one-rank hierarchy over no group.
    """
    if not (dist.is_available() and dist.is_initialized()):
        if slices not in (None, 1):
            raise ValueError(f"hierarchical_mesh: 1 devices do not split into {slices} equal slices")
        return MeshHierarchy(None, None, 1, 1, ((0,),))
    world = dist.get_world_size()
    grid = slice_grid(world, slices, None if slices is not None else _node_ids(world))
    per = len(grid[0])
    # every rank creates every group, ici groups first, then dcn groups, in slice / position order
    ici, _ = dist.new_subgroups_by_enumeration(grid)
    dcn, _ = dist.new_subgroups_by_enumeration([[grid[s][p] for s in range(len(grid))] for p in range(per)])
    return MeshHierarchy(ici, dcn, len(grid), per, tuple(tuple(g) for g in grid))


class HostHierarchy(NamedTuple):
    """Host-plane slice membership: ``slice_of_process[p]`` is the slice of
    process (rank) ``p``. A slice's leader is its lowest rank: the process
    whose copy a slice-leader gather keeps."""

    slice_of_process: Tuple[int, ...]

    @property
    def n_slices(self) -> int:
        return len(set(self.slice_of_process))

    @property
    def leaders(self) -> Tuple[int, ...]:
        """One process a slice (the lowest rank), in slice order."""
        first: dict = {}
        for p, s in enumerate(self.slice_of_process):
            first.setdefault(s, p)
        return tuple(first[s] for s in sorted(first))

    def is_leader(self, process_index: int) -> bool:
        return process_index in self.leaders


def host_hierarchy(slices: Optional[Sequence[int]] = None) -> HostHierarchy:
    """The running job's :class:`HostHierarchy`.

    ``slices`` gives it explicitly: a sequence mapping rank to slice id, one
    entry a rank of the default world. Otherwise a slice is a node, grouped as
    :func:`hierarchical_mesh` groups it (a process of the JAX package holds a
    node's devices; a rank of the port holds one card). One process is one
    slice of one."""
    world = dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1
    if slices is not None:
        mapping = tuple(int(s) for s in slices)
        if len(mapping) != world:
            raise ValueError(f"host_hierarchy: got {len(mapping)} slice ids for {world} processes")
        return HostHierarchy(mapping)
    if world == 1:
        return HostHierarchy((0,))
    slice_of = [0] * world
    for s, ranks in enumerate(slice_grid(world, None, _node_ids(world))):
        for r in ranks:
            slice_of[r] = s
    return HostHierarchy(tuple(slice_of))


# ------------------------------------------------------------ placement policies
def _dist_on() -> bool:
    return dist.is_available() and dist.is_initialized()


def group_world(group: Any) -> int:
    """Ranks a group spans: a :class:`MeshHierarchy`'s size, a process
    group's size, the default world for ``None``, 1 outside a process group."""
    if isinstance(group, MeshHierarchy):
        return group.size
    return dist.get_world_size(group) if _dist_on() else 1


def group_rank(group: Any) -> int:
    """This rank's index in a group: slice-major in a :class:`MeshHierarchy`
    (the order its ``grid`` lists), 0 outside a process group."""
    if not _dist_on():
        return 0
    if isinstance(group, MeshHierarchy):
        me = dist.get_rank()
        for s, ranks in enumerate(group.grid):
            if me in ranks:
                return s * group.per_slice + ranks.index(me)
        raise ValueError(f"rank {me} is not in the hierarchy's grid {group.grid}")
    return dist.get_rank(group)


class RowBlock(NamedTuple):
    """Target of :func:`row_sharded`: a ``PaddedBuffer`` kept as this rank's
    block of ``capacity // world`` rows over ``group`` (a process group, a
    :class:`MeshHierarchy`, or ``None``: the default world)."""

    group: Any
    world: int


class ClassBlock(NamedTuple):
    """Target of :func:`class_sharded`: a state whose leading (class) axis
    syncs block-wise over the hierarchy's ``dcn`` (dp) group and is
    reassembled over its ``ici`` (mp) group."""

    hierarchy: MeshHierarchy


class row_sharded:  # noqa: N801  (a policy, named as the JAX function that makes one)
    """Placement callable for ``Metric.device_put``: keep cat-state
    (``PaddedBuffer``) epoch rows SHARDED over ``group``, the front door to the
    exact sharded epoch compute (counterpart of the JAX package's
    ``row_sharded``).

    ``group`` is a process group, ``None`` (the default world) or a
    :class:`MeshHierarchy` (the JAX form's ``(dcn, ici)`` axes): rows shard
    over both levels in slice-major order and ``compute()`` runs the
    hierarchical engines. Each rank's buffer holds ``capacity // world``
    rows, the block the JAX package gives one device; a rank appends its own
    batches to it. A ``capacity`` that does not divide raises ``ValueError``
    (never a silent replicate). A rank whose block overflows raises at
    ``compute()`` on every rank (the JAX package's appends fill the global
    buffer in order and overflow only on the global count). Other states
    replicate. ``names`` restricts which cat states shard.

    Example::

        auroc = AUROC(pos_label=1, capacity=1_000_000)
        auroc.device_put(row_sharded())
        for preds, target in loader:      # this rank's batches
            auroc.update(preds, target)
        auroc.compute()                   # the exact ring, O(capacity / n) a rank
    """

    kind = "row"

    def __init__(self, group: Any = None, names: Optional[Collection[str]] = None):
        self.group = group
        self.names = None if names is None else frozenset(names)
        self.world = group_world(group)

    def __call__(self, name: str, value: Any) -> Optional[RowBlock]:
        from metrics_tpu_torch.parallel.buffer import PaddedBuffer

        if isinstance(value, PaddedBuffer) and (self.names is None or name in self.names):
            if value.data.shape[0] % self.world:
                raise ValueError(
                    f"row_sharded: state '{name}' capacity {value.data.shape[0]} is not"
                    f" divisible by mesh axis '{self._axis_name()}' size {self.world}; pick a divisible"
                    " `capacity` so every device holds an equal row block."
                )
            return RowBlock(self.group, self.world)
        return None

    def _axis_name(self) -> str:
        return "(dcn, ici)" if isinstance(self.group, MeshHierarchy) else "world" if self.group is None else "group"


class class_sharded:  # noqa: N801
    """Placement callable for ``Metric.device_put``: the class axis of array
    states over the mp level of a 2-D (dp x mp) layout (counterpart of the
    JAX package's ``class_sharded``, in the manual-SPMD form of its
    ``tests/parallel/test_mesh2d.py``).

    ``group`` is a :class:`MeshHierarchy` built by
    ``hierarchical_mesh(slices=dp)``: its ``ici`` group is the mp group (a
    slice), its ``dcn`` group the dp group. Ranks of one slice see the same
    data (:func:`batch_sharded` over ``dcn``). Every rank computes the full
    delta from its data; the per-step and epoch sum-sync runs over dp on the
    rank's own class block only, and the synced blocks are reassembled over
    mp, one ``all_gather_into_tensor`` a dtype. A state whose leading
    dimension does not divide by mp, scalars, buffers, lists and names
    outside ``names`` replicate: they sync whole over dp. Values equal the
    unsharded metric's (integer counts bit for bit).
    """

    kind = "class"

    def __init__(self, group: MeshHierarchy, names: Optional[Collection[str]] = None):
        if not isinstance(group, MeshHierarchy):
            raise TypeError("class_sharded: `group` must be a MeshHierarchy (hierarchical_mesh(slices=dp)), got"
                            f" {type(group).__name__}")
        self.group = group
        self.names = None if names is None else frozenset(names)

    def __call__(self, name: str, value: Any) -> Optional[ClassBlock]:
        if not isinstance(value, Tensor) or value.ndim == 0:  # scalars, PaddedBuffers, lists: replicate
            return None
        if self.names is not None and name not in self.names:
            return None
        if value.shape[0] % self.group.per_slice:
            return None
        return ClassBlock(self.group)


def batch_sharded(group: Any = None, device: Optional[Union[str, torch.device]] = None) -> Callable[[Any], Any]:
    """This rank's block of a global batch (counterpart of the JAX package's
    ``batch_sharded``): given the same batch pytree (tensors in tuples,
    lists and dicts) on every rank, keep block ``rank`` of ``world`` along
    each tensor's leading axis over ``group`` (a process group, ``None``: the
    default world, or a :class:`MeshHierarchy`, slice-major), moved to
    ``device`` when one is given. A leading axis that does not divide raises
    ``ValueError``, as ``NamedSharding`` would."""
    world, rank = group_world(group), group_rank(group)

    def place(batch: Any) -> Any:
        if isinstance(batch, Tensor):
            if batch.ndim == 0:
                return batch if device is None else batch.to(device)
            if batch.shape[0] % world:
                raise ValueError(f"batch_sharded: leading axis {batch.shape[0]} is not divisible by the group"
                                 f" size {world}")
            block = batch.shape[0] // world
            out = batch[rank * block: (rank + 1) * block]
            return out if device is None else out.to(device)
        if isinstance(batch, dict):
            return {k: place(v) for k, v in batch.items()}
        if isinstance(batch, (list, tuple)):
            return type(batch)(place(v) for v in batch)
        return batch

    return place
