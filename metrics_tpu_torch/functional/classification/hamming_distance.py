"""Hamming distance (Hamming loss).

Counterpart of ``metrics_tpu/functional/classification/hamming_distance.py``.
"""
from typing import Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _input_format_classification


def _hamming_distance_update(preds: Tensor, target: Tensor, threshold: float = 0.5) -> Tuple[Tensor, int]:
    preds, target, _ = _input_format_classification(preds, target, threshold=threshold)
    correct = torch.sum(preds == target, dtype=torch.int64)
    return correct, preds.numel()


def _hamming_distance_compute(correct: Tensor, total: Union[int, Tensor]) -> Tensor:
    return 1 - correct.to(torch.float32) / total


def hamming_distance(preds: Tensor, target: Tensor, threshold: float = 0.5) -> Tensor:
    r"""Average fraction of wrongly predicted labels.

    Example:
        >>> import torch
        >>> target = torch.tensor([[0, 1], [1, 1]])
        >>> preds = torch.tensor([[0, 1], [0, 1]])
        >>> float(hamming_distance(preds, target))
        0.25
    """
    correct, total = _hamming_distance_update(preds, target, threshold)
    return _hamming_distance_compute(correct, total)
