"""Exact match (subset accuracy).

Counterpart of ``metrics_tpu/functional/classification/exact_match.py``: a
sample counts as correct only when every position agrees (all labels of a
multilabel row, all elements of a multidim multiclass sample). The two counts
are float32, as in the JAX package, so they are exact up to 2**24 samples.
"""
from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _input_format_classification


def _exact_match_update(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    validate: bool = True,
) -> Tuple[Tensor, Tensor]:
    """(correct, total) sample counts, "sum"-reducible across batches and ranks."""
    p, t, _ = _input_format_classification(
        preds, target, threshold=threshold, num_classes=num_classes, validate=validate
    )
    correct = torch.sum(torch.all((p == t).reshape(p.shape[0], -1), dim=1))
    return correct.to(torch.float32), torch.tensor(float(p.shape[0]), device=p.device)


def _exact_match_compute(correct: Tensor, total: Tensor) -> Tensor:
    return torch.where(total == 0, torch.full_like(correct, float("nan")), correct / torch.clamp_min(total, 1.0))


def exact_match(
    preds: Tensor,
    target: Tensor,
    threshold: float = 0.5,
    num_classes: Optional[int] = None,
    validate: bool = True,
) -> Tensor:
    """Fraction of samples whose prediction matches the target exactly.

    Example (multilabel: every label of a row must agree):
        >>> import torch
        >>> preds = torch.tensor([[0.9, 0.1], [0.8, 0.7]])
        >>> target = torch.tensor([[1, 0], [1, 0]])
        >>> float(exact_match(preds, target))
        0.5
    """
    correct, total = _exact_match_update(preds, target, threshold, num_classes, validate)
    return _exact_match_compute(correct, total)
