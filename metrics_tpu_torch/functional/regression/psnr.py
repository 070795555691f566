"""Peak signal-to-noise ratio. Counterpart of ``metrics_tpu/functional/regression/psnr.py``,
with its per-``dim`` variant."""
import math
from typing import Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.utils.data import upcast_accum
from metrics_tpu_torch.utils.prints import rank_zero_warn_once
from metrics_tpu_torch.utils.reductions import reduce


def _f32(x: Union[float, Tensor]) -> Tensor:
    """A number as a float32 0-d tensor on the CPU, which joins arithmetic on any device."""
    return x if isinstance(x, Tensor) else torch.tensor(float(x), dtype=torch.float32)


def _psnr_compute(
    sum_squared_error: Tensor,
    n_obs: Tensor,
    data_range: Union[float, Tensor],
    base: float = 10.0,
    reduction: str = "elementwise_mean",
) -> Tensor:
    psnr_base_e = 2 * torch.log(_f32(data_range)) - torch.log(sum_squared_error / n_obs)
    return reduce(psnr_base_e * (10 / torch.log(_f32(base))), reduction=reduction)


def _psnr_update(
    preds: Tensor,
    target: Tensor,
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> Tuple[Tensor, Union[int, Tensor]]:
    preds, target = upcast_accum(preds), upcast_accum(target)
    if dim is None:
        return torch.sum((preds - target) ** 2), target.numel()
    dim_list = [dim] if isinstance(dim, int) else list(dim)
    if not dim_list:  # an empty tuple reduces nothing, as ``jnp.sum(axis=())``
        return (preds - target) ** 2, target.numel()
    sum_squared_error = torch.sum((preds - target) ** 2, dim=dim_list)
    n_obs = math.prod(target.shape[d] for d in dim_list)
    return sum_squared_error, torch.full_like(sum_squared_error, n_obs, dtype=torch.int64)


def psnr(
    preds: Tensor,
    target: Tensor,
    data_range: Optional[float] = None,
    base: float = 10.0,
    reduction: str = "elementwise_mean",
    dim: Optional[Union[int, Tuple[int, ...]]] = None,
) -> Tensor:
    """PSNR = ``10 log_base(range^2 n / SSE)``; ``data_range=None`` takes the
    target's span (and needs ``dim=None``).

    Example:
        >>> import torch
        >>> pred = torch.tensor([[0.0, 1.0], [2.0, 3.0]])
        >>> target = torch.tensor([[3.0, 2.0], [1.0, 0.0]])
        >>> round(float(psnr(pred, target)), 4)
        2.5527
    """
    if dim is None and reduction != "elementwise_mean":
        rank_zero_warn_once(f"The `reduction={reduction}` will not have any effect when `dim` is None.")
    if data_range is None:
        if dim is not None:
            raise ValueError("The `data_range` must be given when `dim` is not None.")
        data_range = torch.max(target) - torch.min(target)
    sum_squared_error, n_obs = _psnr_update(preds, target, dim=dim)
    return _psnr_compute(sum_squared_error, n_obs, data_range, base=base, reduction=reduction)
