"""MultiScaleSSIM module: per-image MS-SSIM values streamed into sum / count
states. Counterpart of ``metrics_tpu/regression/ms_ssim.py``; it needs a static
``data_range``, as streaming SSIM does."""
from typing import Any, Callable, Optional, Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.streaming import SumCountMetric
from metrics_tpu_torch.functional.regression.ms_ssim import _DEFAULT_BETAS, multiscale_ssim


class MultiScaleSSIM(SumCountMetric):
    r"""Accumulated multi-scale SSIM, the mean of the per-image values.

    Example:
        >>> import torch
        >>> target = torch.arange(0, 96 * 96, dtype=torch.float32).reshape(1, 1, 96, 96) / (96 * 96)
        >>> preds = target * 0.75
        >>> ms = MultiScaleSSIM(data_range=1.0, kernel_size=(5, 5), device="cpu")
        >>> round(float(ms(preds, target)), 4)
        0.9645
    """

    def __init__(
        self,
        data_range: float,
        kernel_size: Sequence[int] = (11, 11),
        sigma: Sequence[float] = (1.5, 1.5),
        k1: float = 0.01,
        k2: float = 0.03,
        betas: Sequence[float] = _DEFAULT_BETAS,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(compute_on_step=compute_on_step, dist_sync_on_step=dist_sync_on_step,
                         process_group=process_group, dist_sync_fn=dist_sync_fn, device=device)
        if data_range is None:
            raise ValueError("streaming MultiScaleSSIM requires a static `data_range`")
        self.data_range = float(data_range)
        self.kernel_size = tuple(kernel_size)
        self.sigma = tuple(sigma)
        self.k1 = k1
        self.k2 = k2
        self.betas = tuple(betas)

    def _update_stats(self, preds: Tensor, target: Tensor) -> Tuple[Tensor, Any]:
        per_image = multiscale_ssim(preds, target, self.kernel_size, self.sigma, "none", self.data_range,
                                    self.k1, self.k2, self.betas)
        return torch.sum(per_image), per_image.shape[0]
