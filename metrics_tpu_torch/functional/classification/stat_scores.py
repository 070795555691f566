"""True/false positive/negative counts — the base of the classification family.

Counterpart of ``metrics_tpu/functional/classification/stat_scores.py``. The
counting is elementwise mask algebra and sums, as plain torch ops.
"""
from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _input_format_classification
from metrics_tpu_torch.utils.enums import AverageMethod, MDMCAverageMethod


def _drop_column(x: Tensor, index: int) -> Tensor:
    """Remove class column ``index`` from an ``(N, C[, X])`` tensor."""
    return torch.cat([x[:, :index], x[:, index + 1:]], dim=1)


def _stat_scores(preds: Tensor, target: Tensor, reduce: str = "micro") -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """tp/fp/tn/fn (int64) from binary ``(N, C)`` or ``(N, C, X)`` tensors.

    micro -> scalar (or ``(N,)`` for 3d), macro -> ``(C,)`` (or ``(N, C)``),
    samples -> ``(N,)`` (or ``(N, X)``).
    """
    if reduce == "micro":
        dim: Tuple[int, ...] = (0, 1) if preds.ndim == 2 else (1, 2)
    elif reduce == "macro":
        dim = (0,) if preds.ndim == 2 else (2,)
    elif reduce == "samples":
        dim = (1,)
    else:
        raise ValueError(f"The `reduce` {reduce} is not valid.")

    correct = target == preds
    pos = preds == 1

    tp = torch.sum(correct & pos, dim=dim)
    fp = torch.sum(~correct & pos, dim=dim)
    tn = torch.sum(correct & ~pos, dim=dim)
    fn = torch.sum(~correct & ~pos, dim=dim)
    return tp, fp, tn, fn


def _stat_scores_update(
    preds: Tensor,
    target: Tensor,
    reduce: str = "micro",
    mdmc_reduce: Optional[str] = None,
    num_classes: Optional[int] = None,
    top_k: Optional[int] = None,
    threshold: float = 0.5,
    is_multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    preds, target, _ = _input_format_classification(
        preds, target, threshold=threshold, num_classes=num_classes, is_multiclass=is_multiclass, top_k=top_k
    )

    if ignore_index is not None and not 0 <= ignore_index < preds.shape[1]:
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {preds.shape[1]} classes")
    if ignore_index is not None and preds.shape[1] == 1:
        raise ValueError("You can not use `ignore_index` with binary data.")

    if preds.ndim == 3:
        if not mdmc_reduce:
            raise ValueError(
                "When your inputs are multi-dimensional multi-class, you have to set the `mdmc_reduce` parameter"
            )
        if mdmc_reduce == "global":
            preds = torch.transpose(preds, 1, 2).reshape(-1, preds.shape[1])
            target = torch.transpose(target, 1, 2).reshape(-1, target.shape[1])

    if ignore_index is not None and reduce != "macro":
        preds = _drop_column(preds, ignore_index)
        target = _drop_column(target, ignore_index)

    tp, fp, tn, fn = _stat_scores(preds, target, reduce=reduce)

    if ignore_index is not None and reduce == "macro":
        # ignored class statistics are reported as -1
        for stat in (tp, fp, tn, fn):
            stat[..., ignore_index] = -1

    return tp, fp, tn, fn


def _stat_scores_compute(tp: Tensor, fp: Tensor, tn: Tensor, fn: Tensor) -> Tensor:
    outputs = torch.stack([tp, fp, tn, fn, tp + fn], dim=-1)
    return torch.where(outputs < 0, torch.full_like(outputs, -1), outputs)


def stat_scores(
    preds: Tensor,
    target: Tensor,
    reduce: str = "micro",
    mdmc_reduce: Optional[str] = None,
    num_classes: Optional[int] = None,
    top_k: Optional[int] = None,
    threshold: float = 0.5,
    is_multiclass: Optional[bool] = None,
    ignore_index: Optional[int] = None,
) -> Tensor:
    """Count tp/fp/tn/fn(+support) under micro/macro/samples reduction; the
    last axis of the output is ``[tp, fp, tn, fn, support]``.

    Example:
        >>> import torch
        >>> preds = torch.tensor([1, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> stat_scores(preds, target, reduce='macro', num_classes=3)
        tensor([[0, 1, 2, 1, 1],
                [1, 1, 1, 1, 2],
                [1, 0, 3, 0, 1]])
        >>> stat_scores(preds, target, reduce='micro')
        tensor([2, 2, 6, 2, 4])
    """
    if reduce not in ["micro", "macro", "samples"]:
        raise ValueError(f"The `reduce` {reduce} is not valid.")
    if mdmc_reduce not in [None, "samplewise", "global"]:
        raise ValueError(f"The `mdmc_reduce` {mdmc_reduce} is not valid.")
    if reduce == "macro" and (not num_classes or num_classes < 1):
        raise ValueError("When you set `reduce` as 'macro', you have to provide the number of classes.")
    if num_classes and ignore_index is not None and (not 0 <= ignore_index < num_classes or num_classes == 1):
        raise ValueError(f"The `ignore_index` {ignore_index} is not valid for inputs with {num_classes} classes")

    tp, fp, tn, fn = _stat_scores_update(
        preds,
        target,
        reduce=reduce,
        mdmc_reduce=mdmc_reduce,
        top_k=top_k,
        threshold=threshold,
        num_classes=num_classes,
        is_multiclass=is_multiclass,
        ignore_index=ignore_index,
    )
    return _stat_scores_compute(tp, fp, tn, fn)


def _reduce_stat_scores(
    numerator: Tensor,
    denominator: Tensor,
    weights: Optional[Tensor],
    average: Optional[str],
    mdmc_average: Optional[str],
    zero_division: int = 0,
) -> Tensor:
    """Reduce per-class ``numerator/denominator`` scores with micro/macro/
    weighted/none/samples averaging, zero-division handling and ignored
    (negative-denominator) classes."""
    numerator = numerator.to(torch.float32)
    denominator = denominator.to(torch.float32)
    zero_div_mask = denominator == 0
    ignore_mask = denominator < 0

    weights = torch.ones_like(denominator) if weights is None else weights.to(torch.float32)

    numerator = torch.where(zero_div_mask, torch.full_like(numerator, float(zero_division)), numerator)
    denominator = torch.where(zero_div_mask | ignore_mask, torch.ones_like(denominator), denominator)
    weights = torch.where(ignore_mask, torch.zeros_like(weights), weights)

    if average not in (AverageMethod.MICRO, AverageMethod.NONE, None):
        weights = weights / torch.sum(weights, dim=-1, keepdim=True)

    scores = weights * (numerator / denominator)
    # sum(weights) == 0 (only present class ignored with average='weighted') -> 0/0
    scores = torch.where(torch.isnan(scores), torch.full_like(scores, float(zero_division)), scores)

    if mdmc_average == MDMCAverageMethod.SAMPLEWISE:
        scores = torch.mean(scores, dim=0)
        ignore_mask = torch.sum(ignore_mask, dim=0).to(torch.bool)

    if average in (AverageMethod.NONE, None):
        scores = torch.where(ignore_mask, torch.full_like(scores, float("nan")), scores)
    else:
        scores = torch.sum(scores)

    return scores
