"""Accuracy (incl. top-k and subset variants).

Counterpart of ``metrics_tpu/functional/classification/accuracy.py``.
"""
from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _input_format_classification
from metrics_tpu_torch.utils.enums import DataType


def _accuracy_update(
    preds: Tensor,
    target: Tensor,
    threshold: float,
    top_k: Optional[int],
    subset_accuracy: bool,
) -> Tuple[Tensor, Tensor]:
    preds, target, mode = _input_format_classification(preds, target, threshold=threshold, top_k=top_k)

    if mode == DataType.MULTILABEL and top_k:
        raise ValueError("You can not use the `top_k` parameter to calculate accuracy for multi-label inputs.")

    def count(n: int) -> Tensor:
        return torch.tensor(n, dtype=torch.int64, device=target.device)

    if mode == DataType.BINARY or (mode == DataType.MULTILABEL and subset_accuracy):
        correct = torch.sum(torch.all(preds == target, dim=1))
        total = count(target.shape[0])
    elif mode == DataType.MULTILABEL and not subset_accuracy:
        correct = torch.sum(preds == target)
        total = count(target.numel())
    elif mode == DataType.MULTICLASS or (mode == DataType.MULTIDIM_MULTICLASS and not subset_accuracy):
        correct = torch.sum(preds * target, dtype=torch.int64)
        total = torch.sum(target, dtype=torch.int64)
    else:  # multi-dim multi-class, subset accuracy
        sample_correct = torch.sum(preds * target, dim=(1, 2))
        correct = torch.sum(sample_correct == target.shape[2])
        total = count(target.shape[0])

    return correct.to(torch.int64), total


def _accuracy_compute(correct: Tensor, total: Tensor) -> Tensor:
    return correct.to(torch.float32) / total


def accuracy(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    top_k: Optional[int] = None,
    subset_accuracy: bool = False,
) -> Tensor:
    r"""Fraction of correctly classified samples.

    Example:
        >>> import torch
        >>> target = torch.tensor([0, 1, 2, 3])
        >>> preds = torch.tensor([0, 2, 1, 3])
        >>> float(accuracy(preds, target))
        0.5
        >>> target = torch.tensor([0, 1, 2])
        >>> preds = torch.tensor([[0.1, 0.9, 0], [0.3, 0.1, 0.6], [0.2, 0.5, 0.3]])
        >>> round(float(accuracy(preds, target, top_k=2)), 4)
        0.6667
    """
    correct, total = _accuracy_update(preds, target, threshold, top_k, subset_accuracy)
    return _accuracy_compute(correct, total)
