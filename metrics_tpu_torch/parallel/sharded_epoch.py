"""Exact epoch compute over *sharded* epoch data: O(N / n) rows a rank.

Counterpart of ``metrics_tpu/parallel/sharded_epoch.py``. The gather plane
makes every rank hold the whole epoch at ``compute()``; these engines keep it
sharded through compute, each rank holding only its own rows:

- **Curve scalars (AUROC / average precision), curves, ranks**: a ring. Each
  rank sorts its shard once; the sorted pack (scores and cumulative positive
  and negative weights, stacked into one buffer) then visits every other rank
  over n - 1 hops, one ``batch_isend_irecv`` a hop (send to the next rank,
  receive from the previous). At each hop a rank accumulates, for every local
  row, the visiting shard's weight below / tied / at or above its score by
  ``searchsorted`` left and right on the pack. AUROC is then the Mann-Whitney
  U statistic (a tie counts half, which equals the trapezoid over the ROC),
  AP the per-item step integral (every positive sees its tie run's final
  counts), a midrank ``below + (tied + 1) / 2``. Kendall's O(N^2) pairwise
  contraction rides the same ring with the raw rows as payload.
- **Retrieval (per-query) metrics**: an ``all_to_all`` regroup. Rows route to
  rank ``query_id mod n`` through fixed ``(n, capacity)`` buckets (overflow is
  counted, never silent), one ``all_to_all_single`` a payload, so each query
  lands whole on one rank, which runs the single-device grouped engine
  (``RetrievalMetric._device_sums``) on its queries; one sum of the partials
  gives the exact global mean.

The JAX package runs these inside ``shard_map`` over a mesh axis; the port is
SPMD over ``torch.distributed``: ``group`` is a process group (``None``: the
default world) or a :class:`~metrics_tpu_torch.parallel.placement.MeshHierarchy`.
Under a hierarchy each rank's pack (Kendall: its raw rows) crosses the slow
``dcn`` link once, in one ``all_gather``, and the ring circulates the
cross-slice stack over ``ici`` only; the regroup runs in two stages (to the
home slice over ``dcn``, then to the home rank over ``ici``); sums reduce
over ``ici`` first. Outside a process group the world is this rank: the ring
makes no hop and the regroup no exchange. On a one-rank group the ring makes
no hop either, and the regroup still makes its exchanges.

Every collective is entered on the caller's thread in the same order on
every rank (a rank with no rows still sends its full fixed-shape block), is
unguarded, as the JAX package's in-jit collectives and ``buffer_all_gather``
are, and is counted where it is entered, in ``observability.counters``: a ring
hop as ``ppermute``, a regroup exchange as ``all_to_all``, with ring traffic
``payload * (fanout - 1)`` by crossing. The port counts the hops it executes
(n - 1 a ring); the JAX package counts what it stages once a trace.

Numbers: the packs' cumulative weights are float32, as the JAX package's, so
unit-weight counts are exact up to 2**24 rows an epoch; the scalar reductions
run in float64. NaN scores rank as ``-inf``: below every number and tied with
each other (the gather path keeps each NaN its own run in row order, an order
a sharded epoch does not have). Zero weight neutralizes a row; ghost rows of
a capacity block are such rows.
"""
from typing import Any, List, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch import Tensor

from metrics_tpu_torch.observability.counters import record_collective
from metrics_tpu_torch.observability.profiler import annotate
from metrics_tpu_torch.parallel.placement import MeshHierarchy

# pad query id of regroup ghost rows; real query ids must not use it
PAD_QUERY_ID = torch.iinfo(torch.int32).max

__all__ = [
    "PAD_QUERY_ID", "regroup_by_query", "sharded_auroc", "sharded_auroc_matrix", "sharded_average_precision",
    "sharded_average_precision_matrix", "sharded_clf_curve_matrix", "sharded_kendall", "sharded_rank",
    "sharded_retrieval_sums", "sharded_spearman",
]


def _dist_on() -> bool:
    return dist.is_available() and dist.is_initialized()


# ------------------------------------------------------------------ topology
class _Level(NamedTuple):
    """One process group an engine stage runs over, seen from this rank."""

    group: Any
    n: int
    index: int  # this rank's index in the group
    ranks: Tuple[int, ...]  # the group's global ranks, in group order
    crossing: str


def _level(group: Any, crossing: str) -> _Level:
    if not _dist_on():
        return _Level(None, 1, 0, (0,), crossing)
    ranks = tuple(dist.get_process_group_ranks(group)) if group is not None else tuple(range(dist.get_world_size()))
    return _Level(group, len(ranks), ranks.index(dist.get_rank()), ranks, crossing)


class _Topo(NamedTuple):
    """Where an engine's collectives run: the ring level (``ici`` under a
    hierarchy) and, under a hierarchy of several slices, the ``dcn`` level
    a pack crosses once."""

    ring: _Level
    dcn: Optional[_Level]

    @property
    def world(self) -> int:
        return self.ring.n * (self.dcn.n if self.dcn is not None else 1)


def _topo(group: Any) -> _Topo:
    """An engine group's topology; a one-slice hierarchy is the flat ring over its ``ici`` group."""
    if isinstance(group, MeshHierarchy):
        if group.slices == 1:
            return _Topo(_level(group.ici, "ici"), None)
        return _Topo(_level(group.ici, "ici"), _level(group.dcn, "dcn"))
    return _Topo(_level(group, "world"), None)


def _psum_level(x: Tensor, level: _Level) -> Tensor:
    if not _dist_on():
        return x
    x = x.clone()
    record_collective("psum", x, crossing=level.crossing, fanout=level.n)
    dist.all_reduce(x, group=level.group)
    return x


def _engine_psum(x: Tensor, topo: _Topo) -> Tensor:
    """The sum over the engine's ranks: over ``ici`` first under a hierarchy,
    so only the slices' partial sums cross ``dcn``."""
    x = _psum_level(x, topo.ring)
    return _psum_level(x, topo.dcn) if topo.dcn is not None else x


def _hop(payload: Tensor, ring: _Level) -> Tensor:
    """One ring hop: send ``payload`` to the next rank, receive the previous rank's."""
    recv = torch.empty_like(payload)
    record_collective("ppermute", payload, crossing=ring.crossing, fanout=ring.n)
    nxt, prv = ring.ranks[(ring.index + 1) % ring.n], ring.ranks[(ring.index - 1) % ring.n]
    ops = [dist.P2POp(dist.isend, payload, nxt, group=ring.group),
           dist.P2POp(dist.irecv, recv, prv, group=ring.group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return recv


def _gather_level(x: Tensor, level: _Level, kind: str = "all_gather") -> Tensor:
    """``x`` of every rank of ``level``, stacked on a new leading axis in group order."""
    if not _dist_on():
        return x.unsqueeze(0)
    record_collective(kind, x, crossing=level.crossing, fanout=level.n)
    out = x.new_empty((level.n * x.shape[0], *x.shape[1:]))  # concatenated along the first axis
    dist.all_gather_into_tensor(out, x.contiguous(), group=level.group)
    return out.view(level.n, *x.shape)


# ---------------------------------------------------------------- the ring
def _ring_dtype(preds: Tensor) -> torch.dtype:
    return torch.promote_types(preds.dtype, torch.float32) if preds.is_floating_point() else torch.float32


def _pack(preds_cm: Tensor, target_cm: Tensor, weights_cm: Tensor) -> Tensor:
    """One shard's sorted scores and cumulative positive / negative weights,
    per class row: the ``(3, C, m)`` ring payload (the JAX ``_SortedPack``'s
    three leaves, stacked into one buffer)."""
    dtype = _ring_dtype(preds_cm)
    scores, order = torch.sort(_rank_key(preds_cm, dtype), dim=-1, stable=True)
    y = torch.gather(target_cm.to(torch.float32), -1, order)
    w = torch.gather(weights_cm.to(torch.float32), -1, order)
    return torch.stack([scores, torch.cumsum(w * y, -1).to(dtype), torch.cumsum(w * (1.0 - y), -1).to(dtype)])


def _rank_key(preds: Tensor, dtype: torch.dtype) -> Tensor:
    """Scores as the ring ranks them: NaN as ``-inf``."""
    key = preds.to(dtype)
    return torch.where(torch.isnan(key), torch.full_like(key, float("-inf")), key)


def _below_tie_ge(pack: Tensor, q: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per query score of ``q`` (``(C, m)``), the visiting pack's weight sums:
    negative below, negative tied, positive at or above, negative at or above."""
    scores, cum_wp, cum_wn = pack[0].contiguous(), pack[1], pack[2]
    left = torch.searchsorted(scores, q, right=False)
    right = torch.searchsorted(scores, q, right=True)

    def at(cum: Tensor, i: Tensor) -> Tensor:
        return torch.where(i > 0, torch.gather(cum, -1, torch.clamp(i - 1, min=0)), torch.zeros((), dtype=cum.dtype,
                                                                                                 device=cum.device))

    wn_below = at(cum_wn, left)
    wn_tie = at(cum_wn, right) - wn_below
    wp_ge = cum_wp[..., -1:] - at(cum_wp, left)
    wn_ge = cum_wn[..., -1:] - wn_below
    return wn_below, wn_tie, wp_ge, wn_ge


def _accumulate(acc: Optional[List[Tensor]], packs: Tensor, q: Tensor) -> List[Tensor]:
    """Add the statistics of every pack of a ``(k, 3, C, m)`` stack."""
    for pack in packs:
        stats = _below_tie_ge(pack, q)
        acc = list(stats) if acc is None else [a + b for a, b in zip(acc, stats)]
    return acc


def _ring_stats_cols(preds_cm: Tensor, target_cm: Tensor, weights_cm: Tensor, group: Any
                     ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per-class ring statistics for ``(C, m)`` column-major shards: four
    ``(C, m)`` tensors, each local row against the whole epoch.

    The local pack first, then n - 1 hops of the stacked pack (no hop on one
    rank, no dead final hop). Under a hierarchy the pack is first gathered
    over ``dcn`` into a ``(S, 3, C, m)`` stack that circulates over ``ici``:
    every rank still meets every pack exactly once."""
    topo = _topo(group)
    q = _rank_key(preds_cm, _ring_dtype(preds_cm)).contiguous()
    pack = _pack(preds_cm, target_cm, weights_cm)
    visiting = pack.unsqueeze(0) if topo.dcn is None else _gather_level(pack, topo.dcn)
    # the scope labels the ring's hops and kernels on the profiler's timeline
    with annotate("sharded.engine.ring"):
        acc = _accumulate(None, visiting, q)
        for _ in range(topo.ring.n - 1):
            visiting = _hop(visiting, topo.ring)
            acc = _accumulate(acc, visiting, q)
    return tuple(acc)  # type: ignore[return-value]


def _cols(preds: Tensor, target: Tensor, weights: Optional[Tensor]) -> Tuple[Tensor, Tensor, Tensor]:
    """``(m, C)`` inputs (with per-row or per-row-per-class weights) in the
    ``(C, m)`` column-major layout the ring runs on."""
    preds_cm = preds.T
    target_cm = target.T.to(torch.float32)
    if weights is None:
        w_cm = torch.ones(preds_cm.shape, dtype=torch.float32, device=preds.device)
    else:
        w = weights.to(torch.float32)
        w_cm = (w[:, None].expand(preds.shape) if w.ndim == 1 else w).T
    return preds_cm, target_cm, w_cm


def _sum64(x: Tensor) -> Tensor:
    return torch.sum(x.to(torch.float64), dim=-1)


def _nan_where(bad: Tensor, value: Tensor) -> Tensor:
    return torch.where(bad, torch.full_like(value, float("nan")), value)


def sharded_auroc_matrix(preds: Tensor, target: Tensor, group: Any = None, sample_weights: Optional[Tensor] = None,
                         with_support: bool = False) -> Any:
    """Exact per-class AUROCs over epoch rows sharded across ``group``.

    ``preds`` / ``target`` are this rank's ``(m, C)`` rows (0/1 targets a
    column); returns the ``(C,)`` scores, each equal to
    ``sklearn.metrics.roc_auc_score`` on that column of the concatenated
    epoch, cross-shard ties included; ``nan`` where a column has one class
    globally. ``sample_weights`` is per row ``(m,)`` or per row and class
    ``(m, C)``; zero weight neutralizes a row. ``with_support=True`` also
    returns the ``(C,)`` global positive weight, from the same ``all_reduce``.
    """
    preds_cm, y, w = _cols(preds, target, sample_weights)
    wn_below, wn_tie, _, _ = _ring_stats_cols(preds_cm, y, w, group)
    wp = w * y
    stacked = torch.stack([_sum64(wp * (wn_below + 0.5 * wn_tie)), _sum64(wp), _sum64(w * (1.0 - y))])
    u, pos, neg = _engine_psum(stacked, _topo(group))
    denom = pos * neg
    scores = _nan_where(denom == 0, u / torch.where(denom == 0, torch.ones_like(denom), denom)).to(torch.float32)
    return (scores, pos.to(torch.float32)) if with_support else scores


def sharded_average_precision_matrix(preds: Tensor, target: Tensor, group: Any = None,
                                     sample_weights: Optional[Tensor] = None, with_support: bool = False) -> Any:
    """Exact per-class average precision over sharded ``(m, C)`` epoch rows:
    ``(C,)`` scores, ``nan`` where a column has no positive weight globally;
    ``with_support=True`` also returns the global positive weight."""
    preds_cm, y, w = _cols(preds, target, sample_weights)
    _, _, wp_ge, wn_ge = _ring_stats_cols(preds_cm, y, w, group)
    wp = w * y
    contrib = _sum64(wp * wp_ge / torch.clamp(wp_ge + wn_ge, min=1e-38))
    total, pos = _engine_psum(torch.stack([contrib, _sum64(wp)]), _topo(group))
    scores = _nan_where(pos == 0, total / torch.where(pos == 0, torch.ones_like(pos), pos)).to(torch.float32)
    return (scores, pos.to(torch.float32)) if with_support else scores


def sharded_auroc(preds: Tensor, target: Tensor, group: Any = None, sample_weights: Optional[Tensor] = None) -> Tensor:
    """Exact binary AUROC over epoch rows sharded across ``group`` (this
    rank's 1-D rows): ``sklearn.metrics.roc_auc_score`` of the concatenated
    epoch, ``nan`` when a class is absent globally."""
    w = None if sample_weights is None else sample_weights[:, None]
    return sharded_auroc_matrix(preds[:, None], target[:, None], group, w)[0]


def sharded_average_precision(preds: Tensor, target: Tensor, group: Any = None,
                              sample_weights: Optional[Tensor] = None) -> Tensor:
    """Exact binary average precision over epoch rows sharded across
    ``group``: the step integral of the concatenated epoch, ``nan`` with no
    positive weight."""
    w = None if sample_weights is None else sample_weights[:, None]
    return sharded_average_precision_matrix(preds[:, None], target[:, None], group, w)[0]


def _compact_rows(values: Tensor, valid: Tensor, counts: Tensor) -> Tensor:
    """Each row's ``valid`` entries moved to its front in order; the tail
    repeats the row's last one (``curve_static._compact`` over a class axis)."""
    c, n = values.shape
    pos = torch.where(valid, torch.cumsum(valid.to(torch.int64), -1) - 1, torch.full_like(counts[:, None], n))
    out = values.new_zeros((c, n + 1)).scatter_(1, pos, values)[:, :n]
    last = torch.gather(out, 1, torch.clamp(counts - 1, min=0)[:, None])
    return torch.where(torch.arange(n, device=values.device) < counts[:, None], out, last)


def sharded_clf_curve_matrix(preds_cm: Tensor, target_cm: Tensor, weights_cm: Tensor, group: Any = None
                             ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Replicated compacted global clf-curves from ``(C, m)`` column-major
    sharded rows: the distributed route to curve vectors.

    The ring gives every local row the global positive / negative weight at
    or above its score (a tie run's final counts, cross-shard ties
    included); then the finished ``(score, tps, fps, w)`` points of every
    rank come together in one coalesced ``all_gather`` (two stages under a
    hierarchy) and are key-sorted: O(N) a rank for the output, which any
    replicated curve costs. Targets are 0/1 a class; zero weight marks ghost
    rows (they sort last at ``-inf`` and never end a run; real rows must not
    score ``-inf``, the ``curve_static`` contract). Returns ``(fps, tps,
    thresholds, counts)``: ``(C, N)`` tensors with each class's
    distinct-threshold points (descending score) at the front and the final
    point repeated after, and ``(C,)`` counts, the
    ``binary_clf_curve_padded`` contract a class.
    """
    topo = _topo(group)
    w = weights_cm.to(torch.float32)
    p = torch.where(w > 0, _rank_key(preds_cm, _ring_dtype(preds_cm)), float("-inf"))
    _, _, wp_ge, wn_ge = _ring_stats_cols(p, target_cm, w, group)
    dtype = p.dtype
    stacked = torch.stack([-p, wp_ge.to(dtype), wn_ge.to(dtype), w.to(dtype)])  # (4, C, m)
    if topo.dcn is not None:
        stacked = _flat_rows(_gather_level(stacked, topo.dcn, "coalesced_gather"))
    gathered = _flat_rows(_gather_level(stacked, topo.ring, "coalesced_gather"))
    neg_s, order = torch.sort(gathered[0], dim=-1, stable=True)
    tps, fps, wv = (torch.gather(gathered[i], -1, order) for i in (1, 2, 3))
    scores = -neg_s
    last = torch.ones_like(scores[:, :1], dtype=torch.bool)
    run_end = torch.cat([scores[:, 1:] != scores[:, :-1], last], dim=1) & (wv > 0)
    counts = torch.sum(run_end.to(torch.int64), dim=1)
    return (_compact_rows(fps, run_end, counts), _compact_rows(tps, run_end, counts),
            _compact_rows(scores, run_end, counts), counts)


def _flat_rows(stack: Tensor) -> Tensor:
    """A gathered ``(k, 4, C, m)`` stack as ``(4, C, k * m)`` rows."""
    k, f, c, m = stack.shape
    return stack.permute(1, 2, 0, 3).reshape(f, c, k * m)


# ---------------------------------------------------------------- ranks
def _midrank(below: Tensor, tie: Tensor) -> Tensor:
    """1-based average-of-ties rank from (weight strictly below, tied weight incl. self)."""
    return below + (tie + 1.0) / 2.0


def sharded_rank(scores: Tensor, group: Any = None, sample_weights: Optional[Tensor] = None) -> Tensor:
    """Global 1-based midranks (scipy ``rankdata``'s average of ties) of
    epoch rows sharded across ``group``. ``sample_weights`` is a 0/1
    validity mask: ghost rows get ranks that the caller must mask."""
    w = torch.ones(scores.shape, dtype=torch.float32, device=scores.device) if sample_weights is None \
        else sample_weights.to(torch.float32)
    y = torch.zeros_like(w)
    below, tie, _, _ = _ring_stats_cols(scores[None, :], y[None, :], w[None, :], group)
    return _midrank(below[0], tie[0])


def sharded_spearman(preds: Tensor, target: Tensor, group: Any = None,
                     sample_weights: Optional[Tensor] = None) -> Tensor:
    """Exact Spearman rho over epoch rows sharded across ``group``: the
    global midranks of both arrays from one stacked ``(2, m)`` ring, then a
    summed Pearson over the ranks; ``scipy.stats.spearmanr`` of the
    concatenated epoch, cross-shard ties included. ``sample_weights`` is a 0/1
    validity mask. ``nan`` on zero rank variance or an empty epoch."""
    topo = _topo(group)
    w = torch.ones(preds.shape, dtype=torch.float32, device=preds.device) if sample_weights is None \
        else sample_weights.to(torch.float32)
    stacked = torch.stack([preds.to(torch.float32), target.to(torch.float32)])
    below, tie, _, _ = _ring_stats_cols(stacked, torch.zeros_like(stacked), w.expand(stacked.shape), group)
    ranks = _midrank(below, tie).to(torch.float64)
    w64 = w.to(torch.float64)
    total = _engine_psum(torch.sum(w64).reshape(1), topo)[0]
    # ranks scaled to O(1) before the moment sums: correlation is affine-invariant
    rx, ry = ranks[0] / torch.clamp(total, min=1.0), ranks[1] / torch.clamp(total, min=1.0)
    moments = torch.stack([torch.sum(w64 * rx), torch.sum(w64 * ry), torch.sum(w64 * rx * rx),
                           torch.sum(w64 * ry * ry), torch.sum(w64 * rx * ry)])
    sx, sy, sxx, syy, sxy = _engine_psum(moments, topo)
    cov = total * sxy - sx * sy
    var_x = torch.clamp(total * sxx - sx * sx, min=0.0)
    var_y = torch.clamp(total * syy - sy * sy, min=0.0)
    denom = torch.sqrt(var_x) * torch.sqrt(var_y)
    bad = (denom == 0) | (total == 0)
    return _nan_where(bad, cov / torch.where(bad, torch.ones_like(denom), denom)).to(torch.float32)


def _kendall_contract(x: Tensor, y: Tensor, visiting: Tensor, acc: Tensor, chunk: int) -> Tensor:
    """Add, for every local row, the visiting rows' signed concordance and
    tie weights (``visiting`` is ``(3, k)``: x, y, w), in ``chunk``-row blocks."""
    xv, yv, wv = visiting[0], visiting[1], visiting[2]
    for start in range(0, x.shape[0], chunk):
        xc, yc = x[start: start + chunk, None], y[start: start + chunk, None]
        dx = torch.sign(xc - xv)
        dy = torch.sign(yc - yv)
        block = torch.stack([torch.sum(dx * dy * wv, -1), torch.sum((dx == 0) * wv, -1),
                             torch.sum((dy == 0) * wv, -1)])
        acc[:, start: start + chunk] += block
    return acc


def sharded_kendall(preds: Tensor, target: Tensor, group: Any = None, sample_weights: Optional[Tensor] = None,
                    chunk: int = 1024) -> Tensor:
    """Exact global Kendall tau-b over epoch rows sharded across ``group``.

    The O(N^2) pairwise sign contraction split over the ring: the raw
    ``(x, y, w)`` rows circulate, and at each hop a rank contracts its local
    rows against the visiting ones in ``chunk``-row blocks (peak ``chunk x
    k``). Under a hierarchy the raw rows cross ``dcn`` once. Equals
    ``scipy.stats.kendalltau`` (tau-b) of the concatenated epoch.
    ``sample_weights`` is a 0/1 validity mask; ``nan`` when either array is
    constant globally or the epoch is empty."""
    topo = _topo(group)
    x, y = preds.to(torch.float32), target.to(torch.float32)
    w = torch.ones(x.shape, dtype=torch.float32, device=x.device) if sample_weights is None \
        else sample_weights.to(torch.float32)
    rows = torch.stack([x, y, w])
    visiting = rows if topo.dcn is None else _flat_rows(_gather_level(rows[:, None], topo.dcn))[:, 0]
    with annotate("sharded.engine.ring"):
        acc = _kendall_contract(x, y, visiting,
                                torch.zeros((3, x.shape[0]), dtype=torch.float32, device=x.device), max(chunk, 1))
        for _ in range(topo.ring.n - 1):
            visiting = _hop(visiting, topo.ring)
            acc = _kendall_contract(x, y, visiting, acc, max(chunk, 1))
    w64, acc64 = w.to(torch.float64), acc.to(torch.float64)
    sums = torch.stack([torch.sum(w64 * acc64[0]), torch.sum(w64 * acc64[1]), torch.sum(w64 * acc64[2]),
                        torch.sum(w64), torch.sum(w64 * w64)])
    s, t_x, t_y, w_tot, w_sq = _engine_psum(sums, topo)
    s = s / 2.0
    n1 = (t_x - w_sq) / 2.0  # pairs tied in x (the diagonal removed)
    n2 = (t_y - w_sq) / 2.0
    n0 = (w_tot * w_tot - w_sq) / 2.0
    denom = torch.sqrt(torch.clamp(n0 - n1, min=0.0) * torch.clamp(n0 - n2, min=0.0))
    return _nan_where(denom <= 0, s / torch.where(denom > 0, denom, torch.ones_like(denom))).to(torch.float32)


# ---------------------------------------------------------------- regroup
def _exchange(x: Tensor, level: _Level) -> Tensor:
    """One ``all_to_all_single`` of ``(n * capacity,)`` equal buckets."""
    if not _dist_on():
        return x
    record_collective("all_to_all", x, crossing=level.crossing, fanout=level.n)
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=level.group)
    return out


def _route_rows(dest: Tensor, payload: Tuple[Tuple[Tensor, Any], ...], capacity: int, level: _Level
                ) -> Tuple[Tuple[Tensor, ...], Tensor, Tensor]:
    """One fixed-shape routing stage: bucket rows by ``dest`` in ``[0, n)``
    (``n`` marks ghost rows, which take no slot) and exchange the buckets over
    ``level`` with one ``all_to_all_single`` a payload tensor, the real-row
    mask last (as uint8). Returns the routed payloads (each ``(n *
    capacity,)``), the routed real-row mask and this rank's overflow count
    (rows past their bucket's capacity)."""
    n = level.n
    rows = dest.shape[0]
    order = torch.argsort(dest, stable=True)
    sorted_dest = dest[order]
    # a scatter, not ``bincount``: on the card ``bincount`` reads its input's maximum back to the host
    counts = torch.zeros(n + 1, dtype=torch.int64, device=dest.device).scatter_add_(0, dest, torch.ones_like(dest))[:n]
    starts = torch.cumsum(counts, 0) - counts
    slot = torch.arange(rows, device=dest.device) - starts[torch.clamp(sorted_dest, max=n - 1)]
    in_range = (slot < capacity) & (sorted_dest < n)
    flat = torch.where(in_range, sorted_dest * capacity + slot, n * capacity)  # the spare slot: dropped

    def scatter(values: Tensor, fill: Any) -> Tensor:
        out = torch.full((n * capacity + 1,), fill, dtype=values.dtype, device=values.device)
        out[flat] = values[order]
        return out[: n * capacity]

    # the scope labels the regroup's exchanges on the profiler's timeline
    with annotate("sharded.engine.regroup"):
        routed = tuple(_exchange(scatter(values, fill), level) for values, fill in payload)
        real = _exchange(scatter(torch.ones(rows, dtype=torch.uint8, device=dest.device), 0), level).to(torch.bool)
    overflow = torch.sum(torch.clamp(counts - capacity, min=0))
    return routed, real, overflow


def _default_bucket(rows: int, n: int) -> int:
    """Twice the balanced load of a destination, never more than the rows a
    rank holds: a bucket past them is padding that no skew can fill."""
    return max(min(2 * -(-rows // n), rows), 1)


def _payload(idx: Tensor, preds: Tensor, target: Tensor) -> Tuple[Tuple[Tensor, Any], ...]:
    return ((idx, PAD_QUERY_ID), (preds, float("-inf")), (target, 0))


def regroup_by_query(idx: Tensor, preds: Tensor, target: Tensor, group: Any = None, capacity: Optional[int] = None,
                     valid: Optional[Tensor] = None) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Route rows to rank ``query_id mod n`` so each query lands whole on one
    rank (fixed-shape ``all_to_all`` through per-destination buckets).

    Returns ``(idx, preds, target, pad, dropped)``: the first four of shape
    ``(n * capacity,)`` (``pad`` marks ghost rows, which carry
    ``PAD_QUERY_ID``, ``-inf`` and 0), and ``dropped`` the global count of
    rows that overflowed their bucket: check it is zero. ``capacity``
    defaults to ``2 * ceil(rows / n)``, at most ``rows`` (a rank cannot send
    one rank more rows than it holds); raise it for skewed query ids.
    ``valid`` (bool a row) excludes rows: they take no slot, never count as
    dropped, and arrive nowhere. A hierarchy routes in two stages, to the
    home slice over ``dcn`` and to the home rank over ``ici``: each row
    crosses ``dcn`` at most once, and a query's home is world rank ``q mod
    W`` as in the flat regroup.
    """
    topo = _topo(group)
    if topo.dcn is not None:
        return _regroup_by_query_hier(idx, preds, target, topo, capacity, valid)
    ring = topo.ring
    n, rows = ring.n, idx.shape[0]
    if capacity is None:
        capacity = _default_bucket(rows, n)
    dest = torch.remainder(idx.to(torch.int64), n)  # floor mod: negative ids land in [0, n) too
    if valid is not None:
        dest = torch.where(valid, dest, n)
    (g_idx, g_preds, g_target), real, overflow = _route_rows(dest, _payload(idx, preds, target), capacity, ring)
    dropped = _engine_psum(overflow.reshape(1), topo)[0]
    return g_idx, g_preds, g_target, ~real, dropped


def _regroup_by_query_hier(idx: Tensor, preds: Tensor, target: Tensor, topo: _Topo, capacity: Optional[int],
                           valid: Optional[Tensor]) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """The two-stage regroup: to the home slice over ``dcn``, then to the home
    rank over ``ici``, overflow counted at both stages. With ``capacity``
    given a stage-1 bucket takes ``capacity * L`` rows (a slice absorbs its L
    ranks' quota) and a stage-2 bucket ``S * capacity``; the defaults give
    twice the average load a stage, at most the stage's rows."""
    dcn, ici = topo.dcn, topo.ring
    S, L = dcn.n, ici.n
    W = S * L
    rows = idx.shape[0]
    cap1 = _default_bucket(rows, S) if capacity is None else max(capacity * L, 1)
    home = torch.remainder(idx.to(torch.int64), W)  # world rank, slice-major
    s_dest = home // L
    if valid is not None:
        s_dest = torch.where(valid, s_dest, S)
    (i1, p1, t1), real1, over1 = _route_rows(s_dest, _payload(idx, preds, target), cap1, dcn)
    m2 = i1.shape[0]
    cap2 = _default_bucket(m2, L) if capacity is None else max(S * capacity, 1)
    d_dest = torch.where(real1, torch.remainder(torch.remainder(i1.to(torch.int64), W), L), L)
    (i2, p2, t2), real2, over2 = _route_rows(d_dest, _payload(i1, p1, t1), cap2, ici)
    dropped = _engine_psum((over1 + over2).reshape(1), topo)[0]
    return i2, p2, t2, ~real2, dropped


def sharded_retrieval_sums(metric: Any, idx: Tensor, preds: Tensor, target: Tensor, group: Any = None,
                           capacity: Optional[int] = None, valid: Optional[Tensor] = None
                           ) -> Tuple[Tensor, Tensor, Tensor]:
    """Exact global ``(mean, empty-query flag, dropped rows)`` of a
    ``RetrievalMetric`` over epoch rows sharded across ``group``.

    ``metric`` gives the config (grouped kernel, policy, ``exclude``); its
    state is not read. Each rank scores the queries routed to it with
    ``metric._device_sums``, then one float ``all_reduce`` of the score total
    and one int64 ``all_reduce`` of (query count, flag) combine the partials:
    O(local rows) a rank. ``valid`` excludes rows before routing (ghost
    rows of a capacity block)."""
    topo = _topo(group)
    g_idx, g_preds, g_target, pad, dropped = regroup_by_query(idx, preds, target, group, capacity, valid=valid)
    total, count, flag = metric._device_sums(g_idx, g_preds, g_target, pad=pad)
    total = _engine_psum(total.reshape(1), topo)[0]
    # the count and the flag ride one integer collective: a float32 count would lose exactness past 2**24
    count, flag_sum = _engine_psum(torch.stack([count.to(torch.int64), flag.to(torch.int64)]), topo)
    mean = torch.where(count == 0, torch.zeros_like(total), total / torch.clamp(count, min=1))
    return mean, flag_sum > 0, dropped
