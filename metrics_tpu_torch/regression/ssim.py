"""SSIM module. Counterpart of ``metrics_tpu/regression/ssim.py``.

Two modes, chosen as the JAX package chooses them:

- **streaming** (when ``data_range`` is given, the reduction is
  ``elementwise_mean`` or ``sum``, and neither ``capacity`` nor
  ``image_shape`` is): each ``update`` reduces its SSIM map into a float32
  sum and an int64 pixel count, two ``"sum"`` states;
- **stored images** (otherwise, as the reference): ``y`` / ``y_pred`` list
  states of 4-D images (PaddedBuffers with ``capacity``), gathered across
  ranks at ``compute()``, where ``data_range=None`` is inferred from the epoch.
"""
from typing import Any, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.regression.ssim import (
    _check_ssim_params,
    _map_numel,
    _ssim_compute,
    _ssim_update,
)
from metrics_tpu_torch.parallel.buffer import as_values
from metrics_tpu_torch.utils.prints import rank_zero_warn_once


class SSIM(Metric):
    """Accumulated structural similarity.

    Example:
        >>> import torch
        >>> target = torch.arange(0, 16 * 16, dtype=torch.float32).reshape(1, 1, 16, 16) / 256
        >>> preds = target * 0.75
        >>> ssim = SSIM(device="cpu")
        >>> round(float(ssim(preds, target)), 4)
        0.924
    """

    def __init__(
        self,
        kernel_size: Sequence[int] = (11, 11),
        sigma: Sequence[float] = (1.5, 1.5),
        reduction: str = "elementwise_mean",
        data_range: Optional[float] = None,
        k1: float = 0.01,
        k2: float = 0.03,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        capacity: Optional[int] = None,
        image_shape: Optional[Tuple[int, int, int]] = None,
        streaming: Optional[bool] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(compute_on_step=compute_on_step, dist_sync_on_step=dist_sync_on_step,
                         process_group=process_group, capacity=capacity, device=device)
        _check_ssim_params(kernel_size, sigma)
        can_stream = data_range is not None and reduction in ("elementwise_mean", "sum")
        if streaming and not can_stream:
            raise ValueError(
                "`streaming=True` needs a static `data_range` and reduction"
                " 'elementwise_mean' or 'sum' (the per-update map reduction is"
                " exact only for those)."
            )
        if streaming is None:
            # an explicit bounded-buffer request wins over streaming
            streaming = can_stream and capacity is None and image_shape is None
        self.streaming = streaming
        if streaming:
            self.add_state("similarity", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
            self.add_state("total", default=torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")
        else:
            rank_zero_warn_once(
                "Metric `SSIM` will save all targets and"
                " predictions in buffer. For large datasets this may lead"
                " to large memory footprint."
            )
            self.add_state("y", default=[], dist_reduce_fx=None, item_shape=image_shape)
            self.add_state("y_pred", default=[], dist_reduce_fx=None, item_shape=image_shape)
        self.kernel_size = kernel_size
        self.sigma = sigma
        self.data_range = data_range
        self.k1 = k1
        self.k2 = k2
        self.reduction = reduction

    def update(self, preds: Tensor, target: Tensor) -> None:
        preds, target = _ssim_update(preds, target)
        if self.streaming:
            total = _ssim_compute(preds, target, self.kernel_size, self.sigma, "sum", self.data_range, self.k1, self.k2)
            self.similarity = self.similarity + total
            self.total = self.total + _map_numel(preds.shape, self.kernel_size)
        else:
            self._append("y_pred", preds)
            self._append("y", target)

    def compute(self) -> Tensor:
        if self.streaming:
            if self.reduction == "sum":
                return self.similarity
            return self.similarity / torch.clamp_min(self.total, 1)
        return _ssim_compute(as_values(self.y_pred), as_values(self.y), self.kernel_size, self.sigma,
                             self.reduction, self.data_range, self.k1, self.k2)
