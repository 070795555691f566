"""Every query of a retrieval epoch at once: a stable two-pass sort and segment operations.

Counterpart of ``metrics_tpu/functional/retrieval/segments.py``:

1. a stable two-pass sort puts the rows in (query id ascending, score
   descending) order, ties in row order;
2. ranks within a query and within-query relevance counts come from global
   scans minus per-query offsets;
3. per-query sums over the sorted rows.

Two things differ from the JAX package, and neither changes a value below
2**24 relevant rows in an epoch:

* every integer-valued quantity (ranks, within-query relevant counts, the
  per-query relevant / valid / hit totals, first-hit ranks) is an int64 count,
  and float32 division happens once at the end. The JAX package takes a
  float32 global ``cumsum`` minus float32 segment offsets, which stops being
  exact past 2**24 relevant rows and then gives wrong within-query counts for
  the queries after them;
* per-query float sums (AP contributions, NDCG gains) are differences of one
  float64 scan at the segment ends, over rows already sorted by query, then
  rounded to float32: no atomics, so the card gives the same sums on every run.

Integer-valued results come back as int64 where the JAX package returns
float32. Sort keys are ``-score`` with NaN made positive NaN, so NaN scores
rank last (after ``-inf``) on the card as on the CPU.
"""
from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.functional.retrieval.utils import descending_order


def _wide(values: Tensor) -> Tensor:
    """Integer and bool values as int64, float values as float64."""
    return values.to(torch.float64 if values.is_floating_point() else torch.int64)


def segment_sum(values: Tensor, segment_ids: Tensor, num_segments: int) -> Tensor:
    """``jax.ops.segment_sum`` over unsorted ids: int64 for integer and bool values, else
    float32 (``index_add_``: on the card float adds land in another order each run)."""
    wide = values.to(torch.float32 if values.is_floating_point() else torch.int64)
    return torch.zeros(num_segments, dtype=wide.dtype, device=values.device).index_add_(0, segment_ids, wide)


def sorted_segment_sum(values: Tensor, counts: Tensor) -> Tensor:
    """Per-segment sums of rows sorted by segment (``counts`` rows each, in order).

    Integer and bool values sum exactly in int64; float values as differences of
    one float64 inclusive scan at the segment ends, rounded to float32.
    """
    scan = torch.cumsum(_wide(values), 0)
    scan = torch.cat([scan.new_zeros(1), scan])
    ends = torch.cumsum(counts, 0)
    sums = scan[ends] - scan[ends - counts]
    return sums.to(torch.float32) if values.is_floating_point() else sums


def sort_by_query_then_score(dense_idx: Tensor, preds: Tensor, *rest: Tensor) -> Tuple[Tensor, ...]:
    """Rows ordered by (query id ascending, pred descending); stable on ties, NaN preds last."""
    order1 = descending_order(preds)
    order2 = torch.argsort(dense_idx[order1], stable=True)
    order = order1[order2]
    return (dense_idx[order], preds[order], *(r[order] for r in rest))


def segment_positions(sorted_idx: Tensor, num_segments: int) -> Tuple[Tensor, Tensor]:
    """(1-based int64 rank within segment, int64 rows per segment) for sorted ids."""
    counts = segment_sum(torch.ones_like(sorted_idx, dtype=torch.int64), sorted_idx, num_segments)
    starts = torch.cumsum(counts, 0) - counts
    ranks = torch.arange(sorted_idx.shape[0], dtype=torch.int64, device=sorted_idx.device) - starts[sorted_idx] + 1
    return ranks, counts


def within_segment_cumsum(values: Tensor, sorted_idx: Tensor, num_segments: int) -> Tensor:
    """Inclusive cumsum restarting at each segment boundary (ids must be sorted).

    Integer and bool values give exact int64 counts; float values are scanned in
    float64 and returned in their own dtype.
    """
    wide = _wide(values)
    totals = torch.zeros(num_segments, dtype=wide.dtype, device=values.device).index_add_(0, sorted_idx, wide)
    offsets = torch.cumsum(totals, 0) - totals
    out = torch.cumsum(wide, 0) - offsets[sorted_idx]
    return out.to(values.dtype) if values.is_floating_point() else out


def grouped_average_precision(dense_idx: Tensor, preds: Tensor, target: Tensor, num_segments: int) -> Tuple[Tensor, Tensor]:
    """Per-query AP for all queries at once.

    Args:
        dense_idx: (N,) query ids already densified to [0, num_segments).
        preds: (N,) float scores.
        target: (N,) bool relevance.
        num_segments: number of segments (queries).

    Returns:
        (float32 ap_per_query (Q,), int64 relevant_per_query (Q,)): queries with
        no relevant rows get AP 0 (callers apply their empty-query policy).
    """
    d, _, t = sort_by_query_then_score(dense_idx, preds, target.to(torch.int64))
    ranks, counts = segment_positions(d, num_segments)
    within_rel = within_segment_cumsum(t, d, num_segments)
    contrib = torch.where(t > 0, within_rel.to(torch.float32) / ranks.to(torch.float32), 0.0)
    rel_counts = sorted_segment_sum(t, counts)
    ap = sorted_segment_sum(contrib, counts) / torch.clamp(rel_counts, min=1).to(torch.float32)
    return ap, rel_counts


def first_relevant_rank(dense_idx: Tensor, preds: Tensor, target: Tensor, num_segments: int) -> Tensor:
    """Per-query int64 rank of the first relevant row (``target > 0``), 0 where there is none."""
    d, _, t = sort_by_query_then_score(dense_idx, preds, target > 0)
    ranks, _ = segment_positions(d, num_segments)
    none = d.shape[0] + 1
    first = torch.full((num_segments,), none, dtype=torch.int64, device=d.device)
    first.scatter_reduce_(0, d, torch.where(t, ranks, none), "amin")
    return torch.where(first == none, 0, first)


def grouped_reciprocal_rank(dense_idx: Tensor, preds: Tensor, target: Tensor, num_segments: int) -> Tensor:
    """Per-query reciprocal rank of the first relevant row (0 if none)."""
    first = first_relevant_rank(dense_idx, preds, target, num_segments)
    return torch.where(first > 0, 1.0 / torch.clamp(first, min=1).to(torch.float32), 0.0)


def grouped_topk_hits(
    dense_idx: Tensor,
    preds: Tensor,
    target: Tensor,
    num_segments: int,
    k: Optional[int],
    valid: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-query int64 (hits within top-k, total relevant, valid row count).

    ``k=None`` counts hits over the whole query. ``valid`` masks rows that must
    not count toward the per-query document count (exclude sentinels); such
    rows are assumed already neutralized (score -inf, target 0) so they rank
    last and contribute no hits. Graded relevance counts as one hit.
    """
    v = torch.ones_like(dense_idx, dtype=torch.bool) if valid is None else valid
    d, _, t, v = sort_by_query_then_score(dense_idx, preds, (target > 0).to(torch.int64), v)
    ranks, counts = segment_positions(d, num_segments)
    in_topk = t if k is None else t * (ranks <= k)
    return sorted_segment_sum(in_topk, counts), sorted_segment_sum(t, counts), sorted_segment_sum(v, counts)


def grouped_hit_rate(
    dense_idx: Tensor, preds: Tensor, target: Tensor, num_segments: int, k: Optional[int], valid: Optional[Tensor] = None
) -> Tensor:
    """Per-query hit rate: 1.0 if any relevant row ranks in the top-k."""
    hits, _, _ = grouped_topk_hits(dense_idx, preds, target, num_segments, k, valid)
    return (hits > 0).to(torch.float32)


def grouped_fall_out(
    dense_idx: Tensor, preds: Tensor, target: Tensor, num_segments: int, k: Optional[int], valid: Optional[Tensor] = None
) -> Tensor:
    """Per-query fall-out: fraction of NON-relevant docs ranked in the top-k."""
    neg = target <= 0
    if valid is not None:
        neg = neg & valid
    d, _, n = sort_by_query_then_score(dense_idx, preds, neg.to(torch.int64))
    ranks, counts = segment_positions(d, num_segments)
    false_topk = sorted_segment_sum(n if k is None else n * (ranks <= k), counts)
    neg_total = sorted_segment_sum(n, counts)
    return torch.where(neg_total == 0, 0.0, false_topk.to(torch.float32) / torch.clamp(neg_total, min=1).to(torch.float32))


def grouped_r_precision(dense_idx: Tensor, preds: Tensor, target: Tensor, num_segments: int) -> Tensor:
    """Per-query R-precision: hits within the top-R ranks, R = that query's
    relevant count (the cutoff where precision equals recall)."""
    d, _, t = sort_by_query_then_score(dense_idx, preds, (target > 0).to(torch.int64))
    ranks, counts = segment_positions(d, num_segments)
    r_per_query = sorted_segment_sum(t, counts)
    hits = sorted_segment_sum(t * (ranks <= r_per_query[d]), counts)
    return torch.where(r_per_query == 0, 0.0, hits.to(torch.float32) / torch.clamp(r_per_query, min=1).to(torch.float32))


def grouped_ndcg(dense_idx: Tensor, preds: Tensor, target: Tensor, num_segments: int, k: Optional[int] = None) -> Tensor:
    """Per-query NDCG (linear gain) for all queries at once.

    ``k`` truncates both the actual and the ideal ranking at the top-k rows of
    each query. The ideal ordering sorts by (query, target descending) with the
    same stable rule; both orders hold each query's rows in the same positions,
    so they share ranks and discounts.
    """
    target_f = target.to(torch.float32)
    d, _, t = sort_by_query_then_score(dense_idx, preds, target_f)
    ranks, counts = segment_positions(d, num_segments)
    discounts = 1.0 / torch.log2(ranks.to(torch.float32) + 1.0)
    if k is not None:
        discounts = torch.where(ranks <= k, discounts, 0.0)
    dcg = sorted_segment_sum(t * discounts, counts)
    _, _, t_ideal = sort_by_query_then_score(dense_idx, target_f, target_f)
    idcg = sorted_segment_sum(t_ideal * discounts, counts)
    return torch.where(idcg == 0, 0.0, dcg / torch.where(idcg == 0, 1.0, idcg))
