"""Binned (fixed-threshold-grid) curve metrics.

Counterpart of ``metrics_tpu/functional/classification/binned_curves.py``:
the curve is evaluated on a fixed threshold grid, so counts per threshold are
exact for every grid point and additive (``(T,)`` / ``(C, T)`` "sum" states
that sync with one reduction).
"""
from typing import Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.ops.binned import binned_stat_counts


def default_thresholds(num_thresholds: int = 100, dtype=None) -> np.ndarray:
    """Evenly spaced thresholds in [0, 1], as host numpy (the JAX package's grid)."""
    return np.linspace(0.0, 1.0, num_thresholds, dtype=dtype or np.float32)


def _as_thresholds(thresholds: Union[int, Tensor, list, None], device: Optional[torch.device] = None) -> Tensor:
    """The threshold grid as a float32 tensor on ``device``. A user list keeps its order."""
    if thresholds is None:
        thresholds = default_thresholds()
    elif isinstance(thresholds, int):
        thresholds = default_thresholds(thresholds)
    if isinstance(thresholds, Tensor):
        return thresholds.to(device=device if device is not None else thresholds.device, dtype=torch.float32)
    return torch.as_tensor(np.asarray(thresholds, dtype=np.float32), device=device)


def binned_stat_curve_update(
    preds: Tensor,
    target: Tensor,
    thresholds: Tensor,
    impl: str = "auto",
    ranked: Optional[Tuple[Tensor, Tensor]] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Per-threshold TP/FP/TN/FN counts for binary ``(N,)`` or per-class ``(N, C)`` inputs.

    Returns float32 tensors of shape ``(T,)`` (binary) or ``(C, T)``, summable
    across batches and ranks. The threshold contraction is the family's hot
    op: a binary batch on a CUDA device runs kernel K1
    (``csrc/binned_counts.cu``, via ``ops/binned.py:binned_stat_counts``); a
    CPU batch, per-class inputs and empty batches run the plain PyTorch
    version. ``impl`` and ``ranked`` (the grid from ``rank_thresholds``,
    kept by the caller) forward to ``binned_stat_counts``.
    """
    if preds.ndim == 1:
        preds_c, target_c = preds[:, None], target[:, None]
    else:
        preds_c, target_c = preds, target

    # bool 0/1 columns take the kernel's exact integer route
    pos = target_c > 0  # (N, C)
    neg = ~pos
    tp, fp = binned_stat_counts(preds_c, pos, neg, thresholds, impl=impl, ranked=ranked)  # (C, T)
    n_pos = torch.sum(pos, dim=0).to(preds_c.dtype)[:, None]  # (C, 1)
    n_neg = torch.sum(neg, dim=0).to(preds_c.dtype)[:, None]
    fn = n_pos - tp
    tn = n_neg - fp

    if preds.ndim == 1:
        return tp[0], fp[0], tn[0], fn[0]
    return tp, fp, tn, fn


def _precision_recall(tp: Tensor, fp: Tensor, fn: Tensor) -> Tuple[Tensor, Tensor]:
    def ratio(num: Tensor, denom: Tensor) -> Tensor:
        zero = denom == 0
        value = num / torch.where(zero, torch.ones_like(denom), denom)
        return torch.where(zero, torch.zeros_like(value), value)

    return ratio(tp, tp + fp), ratio(tp, tp + fn)


def _roc(tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> Tuple[Tensor, Tensor]:
    tpr = tp / torch.clamp(tp + fn, min=1)
    fpr = fp / torch.clamp(fp + tn, min=1)
    return fpr, tpr


def _auroc(fpr: Tensor, tpr: Tensor) -> Tensor:
    # thresholds ascend -> fpr descends; integrate in ascending-fpr order
    return -torch.trapezoid(tpr, fpr, dim=-1)


def _average_precision(precision: Tensor, recall: Tensor) -> Tensor:
    # step-function integral over descending recall
    return -torch.sum((recall[..., 1:] - recall[..., :-1]) * precision[..., :-1], dim=-1)


def _counts(preds: Tensor, target: Tensor, thresholds) -> Tuple[Tensor, Tuple[Tensor, ...]]:
    thr = _as_thresholds(thresholds, preds.device)
    return thr, binned_stat_curve_update(preds.to(torch.float32), target, thr)


def binned_precision_recall_curve(
    preds: Tensor, target: Tensor, thresholds: Union[int, Tensor, None] = None
) -> Tuple[Tensor, Tensor, Tensor]:
    """Precision/recall evaluated on a fixed threshold grid.

    Example:
        >>> import torch
        >>> preds = torch.tensor([0.1, 0.4, 0.6, 0.8])
        >>> target = torch.tensor([0, 1, 1, 1])
        >>> p, r, t = binned_precision_recall_curve(preds, target, thresholds=torch.tensor([0.0, 0.5, 1.0]))
        >>> p.tolist(), r.tolist()
        ([0.75, 1.0, 0.0], [1.0, 0.6666666865348816, 0.0])
    """
    thr, (tp, fp, tn, fn) = _counts(preds, target, thresholds)
    precision, recall = _precision_recall(tp, fp, fn)
    return precision, recall, thr


def binned_roc(
    preds: Tensor, target: Tensor, thresholds: Union[int, Tensor, None] = None
) -> Tuple[Tensor, Tensor, Tensor]:
    """FPR/TPR evaluated on a fixed threshold grid."""
    thr, (tp, fp, tn, fn) = _counts(preds, target, thresholds)
    fpr, tpr = _roc(tp, fp, tn, fn)
    return fpr, tpr, thr


def binned_auroc(preds: Tensor, target: Tensor, thresholds: Union[int, Tensor, None] = None) -> Tensor:
    """AUROC from the binned ROC via the trapezoidal rule."""
    fpr, tpr, _ = binned_roc(preds, target, thresholds)
    return _auroc(fpr, tpr)


def binned_average_precision(preds: Tensor, target: Tensor, thresholds: Union[int, Tensor, None] = None) -> Tensor:
    """Average precision from the binned PR curve."""
    precision, recall, _ = binned_precision_recall_curve(preds, target, thresholds)
    return _average_precision(precision, recall)
