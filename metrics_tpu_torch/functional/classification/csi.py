"""Critical success index (threat score).

Counterpart of ``metrics_tpu/functional/classification/csi.py``: predictions
and targets are thresholded to events; TP / (TP + FN + FP), correct
negatives ignored.
"""
from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape


def _csi_update(preds: Tensor, target: Tensor, threshold: float) -> Tuple[Tensor, Tensor]:
    """(TP, FP + FN) event counts: int64, "sum"-reducible."""
    _check_same_shape(preds, target)
    p = preds >= threshold
    t = target >= threshold
    return torch.sum(p & t, dtype=torch.int64), torch.sum(p != t, dtype=torch.int64)


def _csi_compute(tp: Tensor, fp_fn: Tensor) -> Tensor:
    tp = tp.to(torch.float32)
    denom = tp + fp_fn.to(torch.float32)
    safe = torch.where(denom > 0, denom, torch.ones_like(denom))
    return torch.where(denom > 0, tp / safe, torch.full_like(tp, float("nan")))


def critical_success_index(preds: Tensor, target: Tensor, threshold: float) -> Tensor:
    """One-shot CSI at ``threshold``: TP / (TP + FN + FP); ``nan`` when no
    event is predicted or observed.

    Example:
        >>> import torch
        >>> preds = torch.tensor([0.9, 0.4, 0.8, 0.1])
        >>> target = torch.tensor([1.0, 0.0, 0.0, 1.0])
        >>> round(float(critical_success_index(preds, target, threshold=0.5)), 4)
        0.3333
    """
    return _csi_compute(*_csi_update(preds, target, threshold))
