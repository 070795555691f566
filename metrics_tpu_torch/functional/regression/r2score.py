"""R^2 from summed moments.

Counterpart of ``metrics_tpu/functional/regression/r2score.py``: ``1 - SS_res /
SS_tot`` with ``SS_tot = sum t^2 - sum t * mean t`` in float32 (the raw-moment
form the reference keeps, ROADMAP section 3), the ``adjusted`` correction and
the three ``multioutput`` modes.
"""
from typing import Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import upcast_accum
from metrics_tpu_torch.utils.prints import rank_zero_warn

_MULTIOUTPUTS = ("raw_values", "uniform_average", "variance_weighted")


def _check_adjusted(adjusted: int) -> None:
    if not isinstance(adjusted, int) or adjusted < 0:
        raise ValueError("`adjusted` parameter should be an integer larger or equal to 0.")


def _r2score_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor, Tensor, int]:
    _check_same_shape(preds, target)
    if preds.ndim > 2:
        raise ValueError(
            "Expected both prediction and target to be 1D or 2D tensors,"
            f" but received tensors with dimension {tuple(preds.shape)}"
        )
    if preds.shape[0] < 2:
        raise ValueError("Needs at least two samples to calculate r2 score.")
    preds, target = upcast_accum(preds), upcast_accum(target)
    sum_error = torch.sum(target, dim=0)
    sum_squared_error = torch.sum(target**2, dim=0)
    residual = torch.sum((target - preds) ** 2, dim=0)
    return sum_squared_error, sum_error, residual, target.shape[0]


def _r2score_compute(
    sum_squared_error: Tensor,
    sum_error: Tensor,
    residual: Tensor,
    total: Union[int, Tensor],
    adjusted: int = 0,
    multioutput: str = "uniform_average",
) -> Tensor:
    mean_error = sum_error / total
    diff = sum_squared_error - sum_error * mean_error
    raw_scores = 1 - (residual / diff)

    if multioutput == "raw_values":
        r2score = raw_scores
    elif multioutput == "uniform_average":
        r2score = torch.mean(raw_scores)
    elif multioutput == "variance_weighted":
        r2score = torch.sum(diff / torch.sum(diff) * raw_scores)
    else:
        raise ValueError(
            "Argument `multioutput` must be either `raw_values`,"
            f" `uniform_average` or `variance_weighted`. Received {multioutput}."
        )
    _check_adjusted(adjusted)
    if adjusted != 0:
        total_i = int(total)  # a host read, on this branch only
        if adjusted > total_i - 1:
            rank_zero_warn(
                "More independent regressions than data points in adjusted r2 score. Falls back to standard r2 score.",
                UserWarning,
            )
        elif adjusted == total_i - 1:
            rank_zero_warn("Division by zero in adjusted r2 score. Falls back to standard r2 score.", UserWarning)
        else:
            r2score = 1 - (1 - r2score) * (total_i - 1) / (total_i - adjusted - 1)
    return r2score


def r2score(preds: Tensor, target: Tensor, adjusted: int = 0, multioutput: str = "uniform_average") -> Tensor:
    r"""R^2 (coefficient of determination): ``1 - SS_res / SS_tot``.

    Example:
        >>> import torch
        >>> target = torch.tensor([3, -0.5, 2, 7])
        >>> preds = torch.tensor([2.5, 0.0, 2, 8])
        >>> round(float(r2score(preds, target)), 4)
        0.9486
        >>> target = torch.tensor([[0.5, 1], [-1, 1], [7, -6]])
        >>> preds = torch.tensor([[0., 2], [-1, 2], [8, -5]])
        >>> [round(float(v), 4) for v in r2score(preds, target, multioutput='raw_values')]
        [0.9654, 0.9082]
    """
    sum_squared_error, sum_error, residual, total = _r2score_update(preds, target)
    return _r2score_compute(sum_squared_error, sum_error, residual, total, adjusted, multioutput)
