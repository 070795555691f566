"""UniversalImageQualityIndex module: the per-window map's sum and count.
Counterpart of ``metrics_tpu/regression/uqi.py``."""
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.streaming import SumCountMetric
from metrics_tpu_torch.functional.regression.ssim import _map_numel
from metrics_tpu_torch.functional.regression.uqi import universal_image_quality_index


class UniversalImageQualityIndex(SumCountMetric):
    r"""Accumulated UQI, the mean over every window of every image seen.

    Example:
        >>> import torch
        >>> target = torch.arange(0, 16 * 16, dtype=torch.float32).reshape(1, 1, 16, 16) / 256
        >>> preds = target * 0.75
        >>> uqi = UniversalImageQualityIndex(device="cpu")
        >>> round(float(uqi(preds, target)), 4)
        0.9216
    """

    def __init__(
        self,
        kernel_size: Sequence[int] = (11, 11),
        sigma: Sequence[float] = (1.5, 1.5),
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(compute_on_step=compute_on_step, dist_sync_on_step=dist_sync_on_step,
                         process_group=process_group, dist_sync_fn=dist_sync_fn, device=device)
        self.kernel_size = tuple(kernel_size)
        self.sigma = tuple(sigma)

    def _update_stats(self, preds: Tensor, target: Tensor) -> Tuple[Tensor, Any]:
        total = universal_image_quality_index(preds, target, self.kernel_size, self.sigma, "sum")
        return total, _map_numel(preds.shape, self.kernel_size)
