"""Precision-recall curve.

Counterpart of ``metrics_tpu/functional/classification/precision_recall_curve.py``:
``_binary_clf_curve`` (the sort + cumulative-sum sweep of scikit-learn's
``_binary_clf_curve``), ``_precision_recall_curve_update`` and
``_precision_recall_curve_compute``. The curves have a data-dependent length
(the number of distinct thresholds), so this is epoch-end code: each
``nonzero`` here is a device sync. The metric modules with a ``capacity`` take
the static-shape kernels of ``curve_static.py`` instead.
"""
from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.utils.prints import rank_zero_warn_once


def _binary_clf_curve(
    preds: Tensor,
    target: Tensor,
    sample_weights: Optional[Sequence] = None,
    pos_label: float = 1.0,
) -> Tuple[Tensor, Tensor, Tensor]:
    """fps / tps / thresholds at each distinct prediction value, descending."""
    if sample_weights is not None and not isinstance(sample_weights, Tensor):
        sample_weights = torch.as_tensor(sample_weights, dtype=torch.float32, device=preds.device)

    # remove class dimension if necessary
    if preds.ndim > target.ndim:
        preds = preds[:, 0]
    # NaN made positive first: the radix sort on the card then puts it first, as the CPU sort does
    key = preds
    if key.is_floating_point():
        key = torch.where(torch.isnan(key), torch.full_like(key, float("nan")), key)
    desc_score_indices = torch.sort(key, descending=True, stable=True).indices

    preds = preds[desc_score_indices]
    target = target[desc_score_indices]

    weight = sample_weights[desc_score_indices] if sample_weights is not None else 1.0

    # indices of distinct prediction values; append the curve end
    distinct_value_indices = torch.nonzero(preds[1:] - preds[:-1])[:, 0]
    end = torch.tensor([target.shape[0] - 1], device=preds.device)
    threshold_idxs = torch.cat([distinct_value_indices, end])
    target = (target == pos_label).to(torch.int32)
    tps = torch.cumsum(target * weight, dim=0)[threshold_idxs]

    if sample_weights is not None:
        # a cumulative sum keeps fps monotone under rounding
        fps = torch.cumsum((1 - target) * weight, dim=0)[threshold_idxs]
    else:
        fps = 1 + threshold_idxs - tps

    return fps, tps, preds[threshold_idxs]


def _swap_flatten(x: Tensor, num_classes: int) -> Tensor:
    """``(N, C, ...)`` to ``(N * ..., C)``, class-major as the JAX package flattens it."""
    return x.transpose(0, 1).reshape(num_classes, -1).transpose(0, 1)


def _precision_recall_curve_update(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
) -> Tuple[Tensor, Tensor, int, int]:
    if not (preds.ndim == target.ndim or preds.ndim == target.ndim + 1):
        raise ValueError("preds and target must have same number of dimensions, or one additional dimension for preds")

    if preds.ndim == target.ndim:
        if pos_label is None:
            rank_zero_warn_once("`pos_label` automatically set 1.")
            pos_label = 1
        if num_classes is not None and num_classes != 1:
            # multilabel problem
            if num_classes != preds.shape[1]:
                raise ValueError(
                    f"Argument `num_classes` was set to {num_classes} in"
                    f" metric `precision_recall_curve` but detected {preds.shape[1]}"
                    " number of classes from predictions"
                )
            preds = _swap_flatten(preds, num_classes)
            target = _swap_flatten(target, num_classes)
        else:
            # binary problem
            preds = preds.reshape(-1)
            target = target.reshape(-1)
            num_classes = 1

    if preds.ndim == target.ndim + 1:
        # multi class problem
        if pos_label is not None:
            rank_zero_warn_once(
                "Argument `pos_label` should be `None` when running"
                f" multiclass precision recall curve. Got {pos_label}"
            )
        if num_classes != preds.shape[1]:
            raise ValueError(
                f"Argument `num_classes` was set to {num_classes} in"
                f" metric `precision_recall_curve` but detected {preds.shape[1]}"
                " number of classes from predictions"
            )
        preds = _swap_flatten(preds, num_classes)
        target = target.reshape(-1)

    return preds, target, num_classes, pos_label


def _precision_recall_curve_compute(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    pos_label: int,
    sample_weights: Optional[Sequence] = None,
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    if num_classes == 1:
        fps, tps, thresholds = _binary_clf_curve(
            preds=preds, target=target, sample_weights=sample_weights, pos_label=pos_label
        )

        precision = tps / (tps + fps)
        recall = tps / tps[-1]

        # stop once full recall is attained; reverse so recall is decreasing
        last_ind = int(torch.nonzero(tps == tps[-1])[0, 0])
        sl = slice(0, last_ind + 1)

        precision = torch.cat([precision[sl].flip(0), torch.ones(1, dtype=precision.dtype, device=precision.device)])
        recall = torch.cat([recall[sl].flip(0), torch.zeros(1, dtype=recall.dtype, device=recall.device)])
        thresholds = thresholds[sl].flip(0)

        return precision, recall, thresholds

    # per-class sweep
    precision, recall, thresholds = [], [], []
    for c in range(num_classes):
        preds_c = preds[:, c]
        res = precision_recall_curve(
            preds=preds_c,
            target=target,
            num_classes=1,
            pos_label=c,
            sample_weights=sample_weights,
        )
        precision.append(res[0])
        recall.append(res[1])
        thresholds.append(res[2])

    return precision, recall, thresholds


def precision_recall_curve(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
) -> Union[Tuple[Tensor, Tensor, Tensor], Tuple[List[Tensor], List[Tensor], List[Tensor]]]:
    """Precision / recall pairs at every distinct threshold.

    Example (binary):
        >>> import torch
        >>> pred = torch.tensor([0, 1, 2, 3])
        >>> target = torch.tensor([0, 1, 1, 0])
        >>> precision, recall, thresholds = precision_recall_curve(pred, target, pos_label=1)
        >>> precision
        tensor([0.6667, 0.5000, 0.0000, 1.0000])
        >>> recall
        tensor([1.0000, 0.5000, 0.0000, 0.0000])
        >>> thresholds
        tensor([1, 2, 3])
    """
    preds, target, num_classes, pos_label = _precision_recall_curve_update(preds, target, num_classes, pos_label)
    return _precision_recall_curve_compute(preds, target, num_classes, pos_label, sample_weights)
