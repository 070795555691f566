"""Log-cosh error and Minkowski distance.

Counterpart of ``metrics_tpu/functional/regression/minkowski.py``.
"""
import math
from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape


def _log_cosh_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    a = torch.abs(preds.to(torch.float32) - target.to(torch.float32))
    # log cosh through the overflow-safe identity |x| + log1p(exp(-2|x|)) - log 2
    vals = a + torch.log1p(torch.exp(-2.0 * a)) - math.log(2.0)
    return torch.sum(vals), target.numel()


def log_cosh_error(preds: Tensor, target: Tensor) -> Tensor:
    """Mean log-cosh of the errors.

    Example:
        >>> import torch
        >>> target = torch.tensor([0.0, 1.0, 2.0])
        >>> preds = torch.tensor([0.5, 1.0, 2.5])
        >>> round(float(log_cosh_error(preds, target)), 4)
        0.0801
    """
    total, n = _log_cosh_update(preds, target)
    return total / max(n, 1)


def _minkowski_update(preds: Tensor, target: Tensor, p: float) -> Tensor:
    if not p >= 1:
        raise ValueError(f"`p` must be >= 1, got {p!r}")
    _check_same_shape(preds, target)
    diff = torch.abs(preds.to(torch.float32) - target.to(torch.float32))
    return torch.sum(diff**p)


def minkowski_distance(preds: Tensor, target: Tensor, p: float = 2.0) -> Tensor:
    """Minkowski distance ``(sum |preds - target|^p)^(1/p)``.

    Example:
        >>> import torch
        >>> target = torch.tensor([0.0, 1.0, 2.0])
        >>> preds = torch.tensor([0.5, 1.0, 2.5])
        >>> round(float(minkowski_distance(preds, target, p=2)), 4)
        0.7071
    """
    return _minkowski_update(preds, target, p) ** (1.0 / p)
