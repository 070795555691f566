"""Mean relative error. Counterpart of ``metrics_tpu/functional/regression/mean_relative_error.py``."""
from typing import Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape


def _mean_relative_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    target_nz = torch.where(target == 0, torch.ones_like(target), target)
    return torch.sum(torch.abs((preds - target) / target_nz)), target.numel()


def _mean_relative_error_compute(sum_rltv_error: Tensor, n_obs: Union[int, Tensor]) -> Tensor:
    return sum_rltv_error / n_obs


def mean_relative_error(preds: Tensor, target: Tensor) -> Tensor:
    """Mean relative error; a zero target divides by 1.

    Example:
        >>> import torch
        >>> x = torch.tensor([0., 1, 2, 3])
        >>> y = torch.tensor([0., 1, 2, 2])
        >>> float(mean_relative_error(x, y))
        0.125
    """
    sum_rltv_error, n_obs = _mean_relative_error_update(preds, target)
    return _mean_relative_error_compute(sum_rltv_error, n_obs)
