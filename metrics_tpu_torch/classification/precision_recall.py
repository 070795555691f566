"""Precision / Recall modules (subclasses of StatScores).

Counterpart of ``metrics_tpu/classification/precision_recall.py``.
"""
from typing import Any, Callable, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.classification.stat_scores import StatScores
from metrics_tpu_torch.functional.classification.precision_recall import (
    _ALLOWED_AVERAGE,
    _precision_compute,
    _recall_compute,
)


class _AveragedStatScores(StatScores):
    """A StatScores whose compute reduces the counts with an ``average``."""

    def __init__(
        self,
        num_classes: Optional[int] = None,
        threshold: float = 0.5,
        average: str = "micro",
        mdmc_average: Optional[str] = None,
        ignore_index: Optional[int] = None,
        top_k: Optional[int] = None,
        is_multiclass: Optional[bool] = None,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        if average not in _ALLOWED_AVERAGE:
            raise ValueError(f"The `average` has to be one of {_ALLOWED_AVERAGE}, got {average}.")

        super().__init__(
            reduce="macro" if average in ["weighted", "none", None] else average,
            mdmc_reduce=mdmc_average,
            threshold=threshold,
            top_k=top_k,
            num_classes=num_classes,
            is_multiclass=is_multiclass,
            ignore_index=ignore_index,
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )
        self.average = average


class Precision(_AveragedStatScores):
    r"""Precision = TP / (TP + FP), accumulated over batches.

    Example:
        >>> import torch
        >>> preds = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> precision = Precision(average='macro', num_classes=3, device="cpu")
        >>> round(float(precision(preds, target)), 4)
        0.1667
    """

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._get_final_stats()
        return _precision_compute(tp, fp, tn, fn, self.average, self.mdmc_reduce)


class Recall(_AveragedStatScores):
    r"""Recall = TP / (TP + FN), accumulated over batches.

    Example:
        >>> import torch
        >>> preds = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> recall = Recall(average='macro', num_classes=3, device="cpu")
        >>> round(float(recall(preds, target)), 4)
        0.3333
    """

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._get_final_stats()
        return _recall_compute(tp, fp, tn, fn, self.average, self.mdmc_reduce)
