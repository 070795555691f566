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

The placement policies (``class_sharded`` / ``row_sharded`` /
``batch_sharded``) are not ported yet.
"""
import os
import socket
from typing import Any, List, NamedTuple, Optional, Sequence, Tuple

import torch.distributed as dist

__all__ = ["HostHierarchy", "MeshHierarchy", "hierarchical_mesh", "host_hierarchy", "slice_grid"]


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
