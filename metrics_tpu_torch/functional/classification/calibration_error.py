"""Calibration error (ECE / MCE / RMSCE).

Counterpart of ``metrics_tpu/functional/classification/calibration_error.py``.
The streaming state is three ``(n_bins,)`` sums: confidence, accuracy and
count per bin. Bins are right-closed uniform bins of the top-1 confidence:
bin ``b`` holds ``conf in (b/B, (b+1)/B]`` (``conf == 0`` lands in bin 0),
found in float32 as ``clip(ceil(conf * B) - 1, 0, B - 1)``. The segment sums
are ``index_add_``: on CUDA it adds with atomics, so the two float32 sums
vary in their last bits from run to run; the int64 count is exact.
"""
from typing import Tuple

import torch
from torch import Tensor

_NORMS = ("l1", "l2", "max")


def _top1_conf_acc(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    """(confidence, correctness) per sample from probabilities.

    ``preds``: (N, C) class probabilities, or (N,) binary positive-class
    probabilities (confidence is then ``max(p, 1 - p)``).
    """
    if preds.ndim == 1:
        conf = torch.maximum(preds, 1.0 - preds)
        pred_label = (preds >= 0.5).to(torch.int32)
    elif preds.ndim == 2:
        conf = torch.amax(preds, dim=-1)
        pred_label = torch.argmax(preds, dim=-1).to(torch.int32)
    else:
        raise ValueError(f"`preds` must be (N,) binary probs or (N, C) probs, got ndim={preds.ndim}")
    if target.shape != pred_label.shape:
        raise ValueError("`target` must have shape (N,) matching `preds`' leading dimension")
    acc = (pred_label == target.to(torch.int32)).to(torch.float32)
    return conf.to(torch.float32), acc


def _calibration_update(preds: Tensor, target: Tensor, n_bins: int) -> Tuple[Tensor, Tensor, Tensor]:
    """Per-bin (confidence sum, accuracy sum, int64 count): plain sum states."""
    conf, acc = _top1_conf_acc(preds, target)
    bins = torch.clamp(torch.ceil(conf * n_bins).to(torch.int64) - 1, 0, n_bins - 1)
    conf_sum = conf.new_zeros(n_bins).index_add_(0, bins, conf)
    acc_sum = acc.new_zeros(n_bins).index_add_(0, bins, acc)
    count = torch.zeros(n_bins, dtype=torch.int64, device=conf.device).index_add_(0, bins, torch.ones_like(bins))
    return conf_sum, acc_sum, count


def _calibration_compute(conf_sum: Tensor, acc_sum: Tensor, count: Tensor, norm: str) -> Tensor:
    count = count.to(torch.float32)
    total = torch.sum(count)
    safe_count = torch.clamp_min(count, 1.0)
    gap = torch.abs(acc_sum / safe_count - conf_sum / safe_count)
    weight = count / torch.clamp_min(total, 1.0)
    if norm == "l1":
        return torch.sum(weight * gap)
    if norm == "max":
        return torch.max(torch.where(count > 0, gap, torch.zeros_like(gap)))
    return torch.sqrt(torch.sum(weight * gap**2))  # l2 (RMS calibration error)


def calibration_error(preds: Tensor, target: Tensor, n_bins: int = 15, norm: str = "l1") -> Tensor:
    """Top-1 calibration error over uniform confidence bins.

    Args:
        preds: (N, C) probabilities or (N,) binary positive-class probs.
        target: (N,) integer labels.
        n_bins: number of uniform bins over [0, 1].
        norm: "l1" (ECE, default), "l2" (RMS), or "max" (MCE).

    Example:
        >>> import torch
        >>> preds = torch.tensor([[0.9, 0.1], [0.6, 0.4], [0.2, 0.8]])
        >>> target = torch.tensor([0, 1, 1])
        >>> round(float(calibration_error(preds, target, n_bins=4)), 4)
        0.3
    """
    if norm not in _NORMS:
        raise ValueError(f"`norm` must be one of {_NORMS}, got {norm!r}")
    if not isinstance(n_bins, int) or n_bins <= 0:
        raise ValueError(f"`n_bins` must be a positive integer, got {n_bins!r}")
    return _calibration_compute(*_calibration_update(preds, target, n_bins), norm)
