"""Specificity module (a StatScores subclass).

Counterpart of ``metrics_tpu/classification/specificity.py``. It runs
StatScores' update, so it joins a matching StatScores / F1 / Precision /
Recall compute group.
"""
from torch import Tensor

from metrics_tpu_torch.classification.precision_recall import _AveragedStatScores
from metrics_tpu_torch.functional.classification.specificity import _specificity_compute


class Specificity(_AveragedStatScores):
    r"""Specificity = TN / (TN + FP), accumulated over batches.

    Example:
        >>> import torch
        >>> preds = torch.tensor([2, 0, 2, 1])
        >>> target = torch.tensor([1, 1, 2, 0])
        >>> spec = Specificity(average='macro', num_classes=3, device="cpu")
        >>> round(float(spec(preds, target)), 4)
        0.6111
        >>> spec = Specificity(average='micro', device="cpu")
        >>> float(spec(preds, target))
        0.625
    """

    def compute(self) -> Tensor:
        tp, fp, tn, fn = self._get_final_stats()
        return _specificity_compute(tp, fp, tn, fn, self.average, self.mdmc_reduce)
