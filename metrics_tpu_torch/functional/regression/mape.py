"""Mean absolute percentage error family (MAPE / SMAPE / WMAPE).

Counterpart of ``metrics_tpu/functional/regression/mape.py``: each is a pair
of sums, so the modules keep two ``"sum"`` states.
"""
from typing import Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape

# the clamp on the denominator, as in the JAX package
_EPS = 1.17e-6


def _mape_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    ratio = torch.abs(preds - target) / torch.clamp_min(torch.abs(target), _EPS)
    return torch.sum(ratio), target.numel()


def _mape_compute(sum_ratio: Tensor, n_obs: Union[int, Tensor]) -> Tensor:
    return sum_ratio / n_obs


def mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    """MAPE: mean of ``|preds - target| / max(|target|, eps)``.

    Example:
        >>> import torch
        >>> target = torch.tensor([1.0, 10.0, 1e6])
        >>> preds = torch.tensor([0.9, 15.0, 1.2e6])
        >>> round(float(mean_absolute_percentage_error(preds, target)), 4)
        0.2667
    """
    return _mape_compute(*_mape_update(preds, target))


def _smape_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    ratio = 2.0 * torch.abs(preds - target) / torch.clamp_min(torch.abs(preds) + torch.abs(target), _EPS)
    return torch.sum(ratio), target.numel()


def symmetric_mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    """SMAPE: mean of ``2 |preds - target| / max(|preds| + |target|, eps)``.

    Example:
        >>> import torch
        >>> target = torch.tensor([1.0, 10.0, 1e6])
        >>> preds = torch.tensor([0.9, 15.0, 1.2e6])
        >>> round(float(symmetric_mean_absolute_percentage_error(preds, target)), 4)
        0.229
    """
    sum_ratio, n_obs = _smape_update(preds, target)
    return sum_ratio / n_obs


def _wmape_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    _check_same_shape(preds, target)
    preds, target = preds.to(torch.float32), target.to(torch.float32)
    return torch.sum(torch.abs(preds - target)), torch.sum(torch.abs(target))


def weighted_mean_absolute_percentage_error(preds: Tensor, target: Tensor) -> Tensor:
    """WMAPE: ``sum |preds - target| / sum |target|``.

    Example:
        >>> import torch
        >>> target = torch.tensor([1.0, 10.0, 100.0])
        >>> preds = torch.tensor([0.9, 15.0, 110.0])
        >>> round(float(weighted_mean_absolute_percentage_error(preds, target)), 4)
        0.136
    """
    abs_error, abs_target = _wmape_update(preds, target)
    return abs_error / torch.clamp_min(abs_target, _EPS)
