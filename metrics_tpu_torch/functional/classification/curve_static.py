"""Static-shape exact binary-curve kernels: AUROC, average precision, padded curves.

Counterpart of ``metrics_tpu/functional/classification/curve_static.py``. The
distinct-threshold points of a curve have a data-dependent count, and
extracting them (``nonzero``) costs a device sync. These kernels keep all N
points instead, and snap every point inside a run of tied scores to the run's
final cumulative counts. Consecutive points then either coincide (a
zero-length segment, which adds nothing to an integral) or are exactly the
distinct-threshold points, so the trapezoid and step integrals equal the ones
over the deduplicated curve, the 50/50 tie handling included.

Every kernel works along the last dimension, so a leading class axis runs all
classes at once (the ``vmap`` of the JAX package). They are torch ops with no
host read: one stable ``torch.sort`` plus gathers, float32 cumulative sums
(exact counts up to 2**24 samples, as in the JAX package) and a blocked
reverse cumulative minimum.
"""
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from metrics_tpu_torch.utils.data import scatter_rows_drop

# block length of the two-level reverse cumulative minimum
_SCAN_BLOCK = 1024


def _reverse_cummin(x: Tensor) -> Tensor:
    """Suffix minimum along the last dimension (``lax.cummin(reverse=True)``).

    ``torch.cummin`` scans one row with a single thread block, so a 12M-long
    row is a long sequential sweep on the GPU. Rows longer than a block are cut
    into blocks of ``_SCAN_BLOCK``: each block's suffix minimum runs in
    parallel over the blocks, then a short scan over the blocks' minima
    carries in what follows each block. Minimum is exact, so the result equals
    the one-row scan bit for bit.
    """
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        return torch.flip(torch.cummin(torch.flip(x, [-1]), dim=-1).values, [-1])
    nb = -(-n // _SCAN_BLOCK)
    blocks = F.pad(x, (0, nb * _SCAN_BLOCK - n), value=float("inf")).reshape(*x.shape[:-1], nb, _SCAN_BLOCK)
    local = torch.flip(torch.cummin(torch.flip(blocks, [-1]), dim=-1).values, [-1])
    after = _reverse_cummin(local[..., 0])  # minimum over each block and those after it
    carry = torch.cat([after[..., 1:], torch.full_like(after[..., :1], float("inf"))], dim=-1)
    out = torch.minimum(local, carry.unsqueeze(-1))
    return out.reshape(*x.shape[:-1], nb * _SCAN_BLOCK)[..., :n]


def _run_end(values: Tensor, valid: Tensor) -> Tensor:
    """Snap each position to ``values`` at the next valid index (a suffix minimum).

    ``values`` must be nondecreasing. Positions after the last valid index
    snap to the total (``values[..., -1]``), which is also the right run end
    for trailing ghost rows (their zero weight leaves the sum at the total).
    """
    masked = torch.where(valid, values, torch.full_like(values, float("inf")))
    return torch.minimum(_reverse_cummin(masked), values[..., -1:])


def _sorted_counts(
    preds: Tensor, target: Tensor, weights: Optional[Tensor] = None, row_mask: Optional[Tensor] = None
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Descending-score cumulative (tps, fps), snapped to tie-run ends.

    Returns ``(tps, fps, scores, valid)`` of ``preds``' shape: every index
    holds its run-final counts, and ``valid`` marks the run-final
    (distinct-threshold) points. NaN scores sort last, each its own run.
    ``row_mask`` excludes ghost rows (capacity padding): they sort after every
    real score at ``-inf`` with zero weight and are never run-final. (A real
    row scoring exactly ``-inf`` merges into the ghost run.)
    """
    if row_mask is not None:
        preds = torch.where(row_mask, preds, torch.full_like(preds, float("-inf"), dtype=torch.float32))
    y_in = target.to(torch.float32).expand(preds.shape)
    w_in = torch.ones_like(y_in) if weights is None else weights.to(torch.float32).expand(preds.shape)
    if row_mask is not None:
        w_in = w_in * row_mask.to(torch.float32)
    # one stable sort of the key, then the labels and weights follow by gather;
    # NaN keys are made positive NaN first, which the radix sort on the card also puts last
    key = -preds
    if key.is_floating_point():
        key = torch.where(torch.isnan(key), torch.full_like(key, float("nan")), key)
    neg_scores, order = torch.sort(key, dim=-1, stable=True)
    y = torch.gather(y_in, -1, order)
    w = torch.gather(w_in, -1, order)
    scores = -neg_scores

    tps = torch.cumsum(y * w, dim=-1)
    fps = torch.cumsum((1.0 - y) * w, dim=-1)
    # run-final = last index of a tie-run (the next score differs; the last index is one)
    last = torch.ones_like(scores[..., :1], dtype=torch.bool)
    valid = torch.cat([scores[..., 1:] != scores[..., :-1], last], dim=-1)
    if row_mask is not None:
        valid = valid & (scores != float("-inf"))
    return _run_end(tps, valid), _run_end(fps, valid), scores, valid


def _prepend_zero(x: Tensor) -> Tensor:
    return torch.cat([torch.zeros_like(x[..., :1]), x], dim=-1)


def _nan_if_zero(total: Tensor) -> Tensor:
    return torch.where(total == 0, torch.full_like(total, float("nan")), total)


def binary_auroc_static(preds: Tensor, target: Tensor, sample_weights: Optional[Tensor] = None) -> Tensor:
    """Exact binary AUROC with static shapes, over the last dimension.

    The trapezoid over the distinct-threshold ROC with an implicit (0, 0)
    start. All-positive or all-negative targets give ``nan``.
    """
    tps, fps, _, _ = _sorted_counts(preds, target, sample_weights)
    tpr = _prepend_zero(tps) / _nan_if_zero(tps[..., -1:])
    fpr = _prepend_zero(fps) / _nan_if_zero(fps[..., -1:])
    return torch.trapezoid(tpr, fpr, dim=-1)


def partial_auroc_from_roc(fpr: Tensor, tpr: Tensor, max_fpr: float) -> Tensor:
    """McClish-corrected partial AUC from a (padded) ROC curve, static shape.

    The trapezoid clipped at ``fpr = max_fpr`` segment by segment: segments
    fully below count whole, the crossing one is interpolated, the rest (and
    the padded tail's zero-width repeats) add nothing. nan rates propagate.
    """
    mf = torch.tensor(max_fpr, dtype=fpr.dtype, device=fpr.device)
    f0, f1 = fpr[:-1], fpr[1:]
    t0, t1 = tpr[:-1], tpr[1:]
    df = f1 - f0
    w = torch.clamp(torch.where(df > 0, (mf - f0) / torch.where(df > 0, df, torch.ones_like(df)), 0.0), 0.0, 1.0)
    t_hi = torch.where(f1 <= mf, t1, t0 + w * (t1 - t0))
    f_hi = torch.minimum(f1, mf)
    partial = torch.sum(torch.where(f0 < f_hi, (f_hi - f0) * (t0 + t_hi) / 2.0, torch.zeros_like(f0)))
    # McClish correction: 0.5 if non-discriminant, 1 if maximal
    min_area = 0.5 * mf * mf
    max_area = mf
    corrected = 0.5 * (1 + (partial - min_area) / (max_area - min_area))
    degenerate = torch.isnan(fpr[-1]) | torch.isnan(tpr[-1])
    return torch.where(degenerate, torch.full_like(corrected, float("nan")), corrected)


def binary_average_precision_static(preds: Tensor, target: Tensor, sample_weights: Optional[Tensor] = None) -> Tensor:
    """Exact binary average precision with static shapes, over the last dimension:
    ``sum_n (R_n - R_{n-1}) * P_n`` over the distinct-threshold points. Zero
    positives give ``nan``."""
    tps, fps, _, _ = _sorted_counts(preds, target, sample_weights)
    precision = tps / torch.clamp(tps + fps, min=1e-38)
    recall = tps / _nan_if_zero(tps[..., -1:])
    # duplicated (snapped) points have zero recall difference: they add nothing
    prev_recall = _prepend_zero(recall[..., :-1])
    return torch.sum((recall - prev_recall) * precision, dim=-1)


# ----------------------------------------------------- padded curve vectors
# The same run-end snapping gives the curve vectors themselves a static
# length: the distinct-threshold points are compacted to the front with a
# valid ``count`` beside them, and the tail repeats the final point, so
# integrals and plots of the full padded arrays are unchanged.


def _compact(values: Tensor, valid: Tensor, count: Tensor) -> Tensor:
    """The ``valid`` entries moved to the front in order (1-D); the tail repeats the last one."""
    n = values.shape[0]
    pos = torch.where(valid, torch.cumsum(valid, 0) - 1, n)
    out = scatter_rows_drop(torch.zeros_like(values), pos, values)
    last = out[torch.clamp(count - 1, min=0)]
    return torch.where(torch.arange(n, device=values.device) < count, out, last)


def binary_clf_curve_padded(
    preds: Tensor,
    target: Tensor,
    sample_weights: Optional[Tensor] = None,
    pos_label: int = 1,
    row_mask: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """``_binary_clf_curve``'s contract with static shapes (1-D inputs).

    Returns ``(fps, tps, thresholds, count)``: length-N tensors with the
    distinct-threshold points (descending score) in the first ``count``
    positions and the final point repeated after; ``count`` is a 0-d tensor.
    """
    y = (target == pos_label).to(torch.int32)
    tps, fps, scores, valid = _sorted_counts(preds, y, sample_weights, row_mask)
    count = torch.sum(valid.to(torch.int64))
    return _compact(fps, valid, count), _compact(tps, valid, count), _compact(scores, valid, count), count


def roc_from_clf_curve(fps: Tensor, tps: Tensor, thresholds: Tensor, count: Tensor) -> Tuple[Tensor, ...]:
    """ROC of a compacted padded clf-curve: (0, 0) prepended, thresholds led by ``max + 1``."""
    tpr = _prepend_zero(tps) / _nan_if_zero(tps[-1])
    fpr = _prepend_zero(fps) / _nan_if_zero(fps[-1])
    thresholds = torch.cat([thresholds[:1] + 1, thresholds])
    return fpr, tpr, thresholds, count + 1


def binary_roc_padded(
    preds: Tensor,
    target: Tensor,
    sample_weights: Optional[Tensor] = None,
    pos_label: int = 1,
    row_mask: Optional[Tensor] = None,
) -> Tuple[Tensor, ...]:
    """Static-shape exact ROC: ``(fpr, tpr, thresholds, count)`` of length N + 1,
    the curve in the first ``count`` positions and (1, 1) repeated after.
    Degenerate targets give ``nan`` rates."""
    return roc_from_clf_curve(*binary_clf_curve_padded(preds, target, sample_weights, pos_label, row_mask))


def precision_recall_from_clf_curve(fps: Tensor, tps: Tensor, th_fw: Tensor, n_distinct: Tensor) -> Tuple[Tensor, ...]:
    """PR curve of a compacted padded clf-curve: reversed, cut at full recall, (1, 0) appended."""
    total = tps[-1]
    precision_fw = tps / torch.clamp(tps + fps, min=1e-38)
    recall_fw = tps / _nan_if_zero(total)

    # stop once full recall is reached (the first index at the total)
    last_ind = torch.argmax((tps >= total).to(torch.uint8))
    n_th = torch.minimum(last_ind + 1, n_distinct)

    n = tps.shape[0]
    j = n_th - 1 - torch.arange(n + 1, device=tps.device)  # reversal; j < 0 is the endpoint or padding
    jc = torch.clamp(j, 0, n - 1)
    precision = torch.where(j >= 0, precision_fw[jc], torch.ones_like(precision_fw[jc]))
    recall = torch.where(j >= 0, recall_fw[jc], torch.zeros_like(recall_fw[jc]))
    thresholds = th_fw[torch.clamp(n_th - 1 - torch.arange(n, device=tps.device), 0, n - 1)]
    return precision, recall, thresholds, n_th


def binary_precision_recall_curve_padded(
    preds: Tensor,
    target: Tensor,
    sample_weights: Optional[Tensor] = None,
    pos_label: int = 1,
    row_mask: Optional[Tensor] = None,
) -> Tuple[Tensor, ...]:
    """Static-shape exact PR curve: ``(precision, recall, thresholds, count)``.
    ``count`` thresholds are kept; ``precision`` / ``recall`` (length N + 1)
    hold ``count + 1`` points; the tails repeat the final entries."""
    return precision_recall_from_clf_curve(
        *binary_clf_curve_padded(preds, target, sample_weights, pos_label, row_mask)
    )


def _per_class_padded(kernel, preds, target, sample_weights=None, row_mask=None):
    """A padded binary kernel over every class column, outputs stacked on a leading class axis.

    Multiclass (labels target): class c against the rest, ``pos_label=c``;
    multilabel (same-shape target): column c against positives == 1.
    """
    num_classes = preds.shape[1]
    if preds.shape == target.shape:
        outs = [kernel(preds[:, c], target[:, c], sample_weights, 1, row_mask) for c in range(num_classes)]
    else:
        outs = [kernel(preds[:, c], target, sample_weights, c, row_mask) for c in range(num_classes)]
    return tuple(torch.stack(parts) for parts in zip(*outs))


def roc_padded(preds, target, sample_weights=None, pos_label=1, row_mask=None):
    """Static-shape exact ROC: binary for 1-D preds, per-class stacked
    ``(C, N + 1)`` curves and ``(C,)`` counts for 2-D preds."""
    if preds.ndim == 1:
        return binary_roc_padded(preds, target, sample_weights, pos_label, row_mask)
    return _per_class_padded(binary_roc_padded, preds, target, sample_weights, row_mask)


def precision_recall_curve_padded(preds, target, sample_weights=None, pos_label=1, row_mask=None):
    """Static-shape exact PR curve: binary for 1-D preds, per-class stacked for 2-D preds."""
    if preds.ndim == 1:
        return binary_precision_recall_curve_padded(preds, target, sample_weights, pos_label, row_mask)
    return _per_class_padded(binary_precision_recall_curve_padded, preds, target, sample_weights, row_mask)
