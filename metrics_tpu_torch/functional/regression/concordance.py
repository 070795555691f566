"""Lin's concordance correlation coefficient, read from Pearson's co-moment vector.

Counterpart of ``metrics_tpu/functional/regression/concordance.py``:
``CCC = 2 cov / (var_p + var_t + (mean_p - mean_t)^2)`` with population
moments, whose ``n`` factors cancel, so the co-moments feed in directly.
"""
import torch
from torch import Tensor

from metrics_tpu_torch.functional.regression.pearson import _CXY, _M2X, _M2Y, _MX, _MY, _N, batch_comoments


def comoments_concordance(c: Tensor) -> Tensor:
    """CCC from a co-moment vector; ``nan`` when the denominator is zero (both
    variances zero and equal means)."""
    denom = c[_M2X] + c[_M2Y] + c[_N] * (c[_MX] - c[_MY]) ** 2
    zero = denom == 0
    return torch.where(zero, torch.full_like(denom, float("nan")),
                       2.0 * c[_CXY] / torch.where(zero, torch.ones_like(denom), denom))


def concordance_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Lin's concordance correlation between two 1-D tensors.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(concordance_corrcoef(preds, target)), 4)
        0.9768
    """
    return comoments_concordance(batch_comoments(preds, target))
