"""Confusion matrix.

Counterpart of ``metrics_tpu/functional/classification/confusion_matrix.py``.
The JAX package contracts int8 one-hots on the MXU; ``torch.matmul`` takes no
integer tensors on CUDA and a float32 product may run in TF32, so the port
counts ``(target, pred)`` label pairs with ``torch.bincount`` in int64 on
every device. Pairs with a label outside ``[0, C)``, and rows the formatter
left all-zero, go to one spare bin past the ``C * C`` counted ones and are
dropped, as the one-hot contraction drops them.
"""
from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _input_format_classification
from metrics_tpu_torch.utils.enums import DataType
from metrics_tpu_torch.utils.prints import rank_zero_warn


def _pair_counts(
    target_labels: Tensor, preds_labels: Tensor, num_classes: int, keep: Optional[Tensor] = None
) -> Tensor:
    """(C, C) int64 count of label pairs; rows = target, cols = preds."""
    t = target_labels.reshape(-1).to(torch.int64)
    p = preds_labels.reshape(-1).to(torch.int64)
    in_range = (t >= 0) & (t < num_classes) & (p >= 0) & (p < num_classes)
    if keep is not None:
        in_range &= keep.reshape(-1)
    spare = num_classes * num_classes
    idx = torch.where(in_range, t * num_classes + p, spare)
    return torch.bincount(idx, minlength=spare + 1)[:spare].view(num_classes, num_classes)


def _confusion_matrix_update(preds: Tensor, target: Tensor, num_classes: int, threshold: float = 0.5) -> Tensor:
    # eager: format without num_classes, so binary data stays binary (the
    # reference branch of the JAX package)
    preds, target, mode = _input_format_classification(preds, target, threshold)
    if mode in (DataType.BINARY, DataType.MULTILABEL):
        return _pair_counts(target, preds, num_classes)
    # multiclass one-hots: the label is the hot column, an all-zero row drops out
    c_fmt = preds.shape[1]
    if preds.ndim == 3:  # (N, C, X) -> (N*X, C)
        preds = torch.movedim(preds, 1, -1).reshape(-1, c_fmt)
        target = torch.movedim(target, 1, -1).reshape(-1, c_fmt)
    keep = (target.amax(dim=1) > 0) & (preds.amax(dim=1) > 0)
    # labels >= num_classes drop out: the truncation of a wider formatted matrix
    return _pair_counts(target.argmax(dim=1), preds.argmax(dim=1), num_classes, keep)


def _confusion_matrix_compute(confmat: Tensor, normalize: Optional[str] = None) -> Tensor:
    allowed_normalize = ("true", "pred", "all", "none", None)
    if normalize not in allowed_normalize:
        raise ValueError(f"Argument average needs to one of the following: {allowed_normalize}")
    confmat = confmat.to(torch.float32)
    if normalize is not None and normalize != "none":
        if normalize == "true":
            cm = confmat / torch.sum(confmat, dim=1, keepdim=True)
        elif normalize == "pred":
            cm = confmat / torch.sum(confmat, dim=0, keepdim=True)
        else:  # 'all'
            cm = confmat / torch.sum(confmat)
        nan_mask = torch.isnan(cm)
        nan_count = int(torch.sum(nan_mask))
        if nan_count:
            rank_zero_warn(f"{nan_count} nan values found in confusion matrix have been replaced with zeros.")
        return torch.where(nan_mask, torch.zeros_like(cm), cm)
    return confmat


def confusion_matrix(
    preds: Tensor, target: Tensor, num_classes: int, normalize: Optional[str] = None, threshold: float = 0.5
) -> Tensor:
    """Confusion matrix for binary, multiclass and multilabel data.

    ``normalize``: None/'none' (counts), 'true' (over rows), 'pred' (over
    columns), 'all' (over everything); NaNs from empty rows become 0.

    Example:
        >>> import torch
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> confusion_matrix(preds, target, num_classes=2)
        tensor([[2., 0.],
                [1., 1.]])
    """
    confmat = _confusion_matrix_update(preds, target, num_classes, threshold)
    return _confusion_matrix_compute(confmat, normalize)
