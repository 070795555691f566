"""ConcordanceCorrCoef module: Pearson's co-moment state, another compute.

Counterpart of ``metrics_tpu/regression/concordance.py``.
"""
from torch import Tensor

from metrics_tpu_torch.functional.regression.concordance import comoments_concordance
from metrics_tpu_torch.regression.pearson import PearsonCorrcoef


class ConcordanceCorrCoef(PearsonCorrcoef):
    r"""Accumulated Lin concordance correlation coefficient.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> ccc = ConcordanceCorrCoef(device="cpu")
        >>> round(float(ccc(preds, target)), 4)
        0.9768
    """

    def compute(self) -> Tensor:
        return comoments_concordance(self.comoments)
