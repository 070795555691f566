"""Area under the ROC curve.

Counterpart of ``metrics_tpu/functional/classification/auroc.py``
(``_auroc_update``, ``_auroc_compute``, ``_auroc_class_scores``,
``_check_pos_neg_eager``): per-class AUROC by the static-shape kernel with
macro / weighted / micro averaging, and partial AUC (``max_fpr``) with the
McClish correction. The all-positive / all-negative checks reduce on the
device and cost one host read of the stacked flags. ``auroc`` runs in a
``deferred_value_checks`` window, as in the JAX package: the input checks and
these flags go into flight as non-blocking copies and one wait reads them all.
"""
from typing import Optional, Sequence

import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.curve_static import (
    binary_auroc_static,
    binary_roc_padded,
    partial_auroc_from_roc,
)
from metrics_tpu_torch.utils.checks import (
    _input_format_classification,
    defer_or_run_value_check,
    deferred_value_checks,
    flags_when_checked,
)
from metrics_tpu_torch.utils.data import ClassScores
from metrics_tpu_torch.utils.enums import AverageMethod, DataType
from metrics_tpu_torch.utils.prints import rank_zero_warn_once

_NO_NEGATIVES = "No negative samples in targets, false positive value should be meaningless"
_NO_POSITIVES = "No positive samples in targets, true positive value should be meaningless"


def _check_pos_neg_eager(y: Tensor) -> None:
    """Raise when ``y`` (0/1, one column per class on the last axis, or 1-D)
    has a class with no negative or no positive sample. ONE host read, which a
    ``deferred_value_checks`` window postpones."""
    pos = y > 0
    read = flags_when_checked(torch.stack([torch.all(pos, dim=0), torch.any(pos, dim=0)]).reshape(2, -1))

    def finalize() -> None:
        for all_pos, any_pos in zip(*read()):
            if all_pos:
                raise ValueError(_NO_NEGATIVES)
            if not any_pos:
                raise ValueError(_NO_POSITIVES)

    defer_or_run_value_check(finalize)


def _weights(sample_weights: Optional[Sequence], device: torch.device) -> Optional[Tensor]:
    return None if sample_weights is None else torch.as_tensor(sample_weights, dtype=torch.float32, device=device)


def _auroc_class_scores(
    preds: Tensor, target: Tensor, columns: str, pos_label: int, sample_weights: Optional[Sequence],
    validate: bool = True,
) -> Tensor:
    """(C,) one-vs-rest AUROCs by the static kernel, all classes at once.

    ``columns`` picks how per-class binary targets are made: ``"labels"``
    (multiclass: class c against the rest) or ``"multilabel"`` (column c).
    """
    num_classes = preds.shape[1]
    if columns == "labels":
        onehot = (target[:, None] == torch.arange(num_classes, device=target.device)).to(torch.int32)
    else:
        onehot = (target == pos_label).to(torch.int32)
    if validate:
        _check_pos_neg_eager(onehot)
    return binary_auroc_static(preds.T, onehot.T, _weights(sample_weights, preds.device))


def _binary_setup(preds: Tensor, target: Tensor, pos_label, validate: bool):
    """The shared binary preamble: ``pos_label`` default (with a warning),
    the ``(rows, 1)`` squeeze, the 0/1 target and the value checks."""
    if pos_label is None:
        rank_zero_warn_once("`pos_label` automatically set 1.")
        pos_label = 1
    p = preds[:, 0] if preds.ndim > target.ndim else preds
    y = (target == pos_label).to(torch.int32)
    if validate:
        _check_pos_neg_eager(y)
    return p, y


def _auroc_update(preds: Tensor, target: Tensor, validate: bool = True):
    # validate the input and resolve the data mode
    _, _, mode = _input_format_classification(preds, target, validate=validate)

    if mode == DataType.MULTIDIM_MULTICLASS:
        n_classes = preds.shape[1]
        preds = preds.transpose(0, 1).reshape(n_classes, -1).transpose(0, 1)
        target = target.reshape(-1)
    if mode == DataType.MULTILABEL and preds.ndim > 2:
        n_classes = preds.shape[1]
        preds = preds.transpose(0, 1).reshape(n_classes, -1).transpose(0, 1)
        target = target.transpose(0, 1).reshape(n_classes, -1).transpose(0, 1)

    return preds, target, mode


def _auroc_compute(
    preds: Tensor,
    target: Tensor,
    mode: DataType,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    max_fpr: Optional[float] = None,
    sample_weights: Optional[Sequence] = None,
    validate: bool = True,
) -> Tensor:
    if mode == DataType.BINARY:
        num_classes = 1

    if max_fpr is not None:
        if not isinstance(max_fpr, float) or not 0 < max_fpr <= 1:
            raise ValueError(f"`max_fpr` should be a float in range (0, 1], got: {max_fpr}")
        if mode != DataType.BINARY:
            raise ValueError(
                "Partial AUC computation not available in"
                " multilabel/multiclass setting, 'max_fpr' must be"
                f" set to `None`, received `{max_fpr}`."
            )

    weights = _weights(sample_weights, preds.device)
    if max_fpr is None or max_fpr == 1:
        if mode == DataType.MULTILABEL and average == AverageMethod.MICRO:
            p, y = _binary_setup(preds.reshape(-1), target.reshape(-1), pos_label, validate)
            return binary_auroc_static(p, y, weights)

        if num_classes != 1:
            if mode == DataType.MULTILABEL:
                # per-column curves are always against positives == 1
                auc_scores = _auroc_class_scores(preds, target, "multilabel", 1, sample_weights, validate)
            else:
                if pos_label is not None:
                    rank_zero_warn_once(
                        "Argument `pos_label` should be `None` when running"
                        f" multiclass AUROC. Got {pos_label}"
                    )
                auc_scores = _auroc_class_scores(preds, target, "labels", 1, sample_weights, validate)

            if average == AverageMethod.NONE:
                return ClassScores(auc_scores)
            if average == AverageMethod.MACRO:
                return torch.mean(auc_scores)
            if average == AverageMethod.WEIGHTED:
                if mode == DataType.MULTILABEL:
                    support = torch.sum(target, dim=0)
                else:
                    support = torch.bincount(target.reshape(-1), minlength=num_classes)[:num_classes]
                return torch.sum(auc_scores * support / torch.sum(support))

            allowed_average = (AverageMethod.NONE.value, AverageMethod.MACRO.value, AverageMethod.WEIGHTED.value)
            raise ValueError(
                f"Argument `average` expected to be one of the following: {allowed_average} but got {average}"
            )

        p, y = _binary_setup(preds, target, pos_label, validate)
        return binary_auroc_static(p, y, weights)

    # partial AUC: the padded ROC and the segment-clipped McClish transform
    p, y = _binary_setup(preds, target, pos_label, validate)
    fpr, tpr, _, _ = binary_roc_padded(p, y, weights)
    return partial_auroc_from_roc(fpr, tpr, max_fpr)


def auroc(
    preds: Tensor,
    target: Tensor,
    num_classes: Optional[int] = None,
    pos_label: Optional[int] = None,
    average: Optional[str] = "macro",
    max_fpr: Optional[float] = None,
    sample_weights: Optional[Sequence] = None,
    validate: bool = True,
) -> Tensor:
    """Area under the receiver operating characteristic curve.

    Example (binary):
        >>> import torch
        >>> preds = torch.tensor([0.13, 0.26, 0.08, 0.19, 0.34])
        >>> target = torch.tensor([0, 0, 1, 1, 1])
        >>> float(auroc(preds, target, pos_label=1))
        0.5

    Example (multiclass):
        >>> preds = torch.tensor([[0.90, 0.05, 0.05],
        ...                       [0.05, 0.90, 0.05],
        ...                       [0.05, 0.05, 0.90],
        ...                       [0.85, 0.05, 0.10],
        ...                       [0.10, 0.10, 0.80]])
        >>> target = torch.tensor([0, 1, 1, 2, 2])
        >>> round(float(auroc(preds, target, num_classes=3)), 4)
        0.7778
    """
    # one deferred-read window: the input checks, the positive / negative
    # checks and the result go into flight together, and one wait reads them
    with deferred_value_checks():
        preds, target, mode = _auroc_update(preds, target, validate=validate)
        result = _auroc_compute(preds, target, mode, num_classes, pos_label, average, max_fpr, sample_weights,
                                validate)
    return result
