"""Average precision: the area under the PR curve as a step function.

Counterpart of ``metrics_tpu/functional/classification/average_precision.py``.
Binary and multiclass run the static-shape kernel (``curve_static.py``), every
class at once; the multilabel layout keeps the dynamic-curve sweep, as in the
JAX package. A class with no positives gives ``nan``.
"""
from typing import List, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.curve_static import binary_average_precision_static
from metrics_tpu_torch.functional.classification.precision_recall_curve import (
    _precision_recall_curve_compute,
    _precision_recall_curve_update,
)
from metrics_tpu_torch.utils.checks import deferred_value_checks
from metrics_tpu_torch.utils.data import ClassScores


def _average_precision_update(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
) -> Tuple[Tensor, Tensor, int, int]:
    return _precision_recall_curve_update(preds, target, num_classes, pos_label)


def _average_precision_compute(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    pos_label: int,
    sample_weights: Optional[Sequence] = None,
) -> Union[List[Tensor], Tensor]:
    if preds.shape[0] == 0:
        # the JAX package raises here too: an AP over no samples is undefined, not 0.0
        raise IndexError("index is out of bounds for axis 0 with size 0")
    weights = None if sample_weights is None else torch.as_tensor(sample_weights, dtype=torch.float32, device=preds.device)

    if num_classes == 1:
        p = preds[:, 0] if preds.ndim > target.ndim else preds
        y = (target == pos_label).to(torch.int32)
        return binary_average_precision_static(p, y, weights)

    if preds.shape != target.shape:
        # multiclass one-vs-rest, every class at once
        onehot = (target[:, None] == torch.arange(num_classes, device=target.device)).to(torch.int32)
        return ClassScores(binary_average_precision_static(preds.T, onehot.T, weights))

    precision, recall, _ = _precision_recall_curve_compute(preds, target, num_classes, pos_label)
    return ClassScores(torch.stack([-torch.sum((r[1:] - r[:-1]) * p[:-1]) for p, r in zip(precision, recall)]))


def average_precision(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    sample_weights: Optional[Sequence] = None,
) -> Union[List[Tensor], Tensor]:
    """Average precision score.

    Example (binary):
        >>> import torch
        >>> pred = torch.tensor([0, 1, 2, 3])
        >>> target = torch.tensor([0, 1, 1, 1])
        >>> float(average_precision(pred, target, pos_label=1))
        1.0

    Example (multiclass):
        >>> pred = torch.tensor([[0.75, 0.05, 0.05, 0.05, 0.05],
        ...                      [0.05, 0.75, 0.05, 0.05, 0.05],
        ...                      [0.05, 0.05, 0.75, 0.05, 0.05],
        ...                      [0.05, 0.05, 0.05, 0.75, 0.05]])
        >>> target = torch.tensor([0, 1, 3, 2])
        >>> [float(x) for x in average_precision(pred, target, num_classes=5)]
        [1.0, 1.0, 0.25, 0.25, nan]
    """
    with deferred_value_checks():  # the input checks' reads wait once, with the result's
        preds, target, num_classes, pos_label = _average_precision_update(preds, target, num_classes, pos_label)
        result = _average_precision_compute(preds, target, num_classes, pos_label, sample_weights)
    return result
