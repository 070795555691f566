"""MSLE. Counterpart of ``metrics_tpu/functional/regression/mean_squared_log_error.py``."""
from typing import Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import upcast_accum


def _mean_squared_log_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    preds, target = upcast_accum(preds), upcast_accum(target)
    return torch.sum((torch.log1p(preds) - torch.log1p(target)) ** 2), target.numel()


def _mean_squared_log_error_compute(sum_squared_log_error: Tensor, n_obs: Union[int, Tensor]) -> Tensor:
    return sum_squared_log_error / n_obs


def mean_squared_log_error(preds: Tensor, target: Tensor) -> Tensor:
    """Mean squared log error.

    Example:
        >>> import torch
        >>> x = torch.tensor([0., 1, 2, 3])
        >>> y = torch.tensor([0., 1, 2, 2])
        >>> round(float(mean_squared_log_error(x, y)), 4)
        0.0207
    """
    sum_squared_log_error, n_obs = _mean_squared_log_error_update(preds, target)
    return _mean_squared_log_error_compute(sum_squared_log_error, n_obs)
