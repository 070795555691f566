"""SpectralAngleMapper / ERGAS modules: per-image values streamed into sum /
count states. Counterpart of ``metrics_tpu/regression/spectral.py``."""
from typing import Any, Callable, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.streaming import SumCountMetric
from metrics_tpu_torch.functional.regression.spectral import (
    error_relative_global_dimensionless_synthesis,
    spectral_angle_mapper,
)


class SpectralAngleMapper(SumCountMetric):
    r"""Accumulated mean spectral angle (radians) over the images seen.

    Example:
        >>> import torch
        >>> target = torch.stack([torch.ones((1, 8, 8)), torch.zeros((1, 8, 8))], dim=1)
        >>> preds = torch.stack([torch.ones((1, 8, 8)), torch.ones((1, 8, 8))], dim=1)
        >>> sam = SpectralAngleMapper(device="cpu")
        >>> round(float(sam(preds, target)), 4)
        0.7854
    """

    def _update_stats(self, preds: Tensor, target: Tensor) -> Tuple[Tensor, Any]:
        values = spectral_angle_mapper(preds, target, reduction="none")
        return torch.sum(values), values.shape[0]


class ErrorRelativeGlobalDimensionlessSynthesis(SumCountMetric):
    r"""Accumulated ERGAS, the mean of the per-image values; lower is better.

    Example:
        >>> import torch
        >>> target = torch.ones((1, 2, 8, 8))
        >>> ergas = ErrorRelativeGlobalDimensionlessSynthesis(device="cpu")
        >>> round(float(ergas(target * 0.9, target)), 4)
        40.0
    """

    def __init__(
        self,
        ratio: float = 4.0,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(compute_on_step=compute_on_step, dist_sync_on_step=dist_sync_on_step,
                         process_group=process_group, dist_sync_fn=dist_sync_fn, device=device)
        if ratio <= 0:
            raise ValueError(f"`ratio` must be positive, got {ratio!r}")
        self.ratio = float(ratio)

    def _update_stats(self, preds: Tensor, target: Tensor) -> Tuple[Tensor, Any]:
        values = error_relative_global_dimensionless_synthesis(preds, target, self.ratio, reduction="none")
        return torch.sum(values), values.shape[0]
