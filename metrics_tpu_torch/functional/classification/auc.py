"""Area under a curve by the trapezoidal rule.

Counterpart of ``metrics_tpu/functional/classification/auc.py``: a direction
check (increasing, decreasing, or neither with ``reorder=False``) in one host
read, then the trapezoid.
"""
from typing import Tuple

import torch
from torch import Tensor


def _auc_update(x: Tensor, y: Tensor) -> Tuple[Tensor, Tensor]:
    if x.ndim > 1 or y.ndim > 1:
        raise ValueError(
            f"Expected both `x` and `y` tensor to be 1d, but got tensors with dimention {x.ndim} and {y.ndim}"
        )
    if x.numel() != y.numel():
        raise ValueError(
            f"Expected the same number of elements in `x` and `y` tensor but received {x.numel()} and {y.numel()}"
        )
    return x, y


def _auc_compute(x: Tensor, y: Tensor, reorder: bool = False) -> Tensor:
    if reorder:
        idx = torch.sort(x, stable=True).indices
        x, y = x[idx], y[idx]

    dx = x[1:] - x[:-1]
    any_neg, all_nonpos = torch.stack([torch.any(dx < 0), torch.all(dx <= 0)]).tolist()  # ONE host read
    if any_neg:
        if not all_nonpos:
            raise ValueError(
                "The `x` tensor is neither increasing or decreasing. Try setting the reorder argument to `True`."
            )
        direction = -1.0
    else:
        direction = 1.0
    return direction * torch.trapezoid(y, x)


def auc(x: Tensor, y: Tensor, reorder: bool = False) -> Tensor:
    """Area under the (x, y) curve by the trapezoidal rule.

    Example:
        >>> import torch
        >>> x = torch.tensor([0, 1, 2, 3])
        >>> y = torch.tensor([0, 1, 2, 2])
        >>> float(auc(x, y))
        4.0
        >>> float(auc(x.flip(0), y, reorder=True))
        4.0
    """
    x, y = _auc_update(x, y)
    return _auc_compute(x, y, reorder=reorder)
