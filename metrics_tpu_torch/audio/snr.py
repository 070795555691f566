"""SNR module. Counterpart of ``metrics_tpu/audio/snr.py``."""
from typing import Any, Callable, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.audio.base import _PerExampleDbMetric
from metrics_tpu_torch.functional.audio.snr import _snr_per_example


class SNR(_PerExampleDbMetric):
    r"""Accumulated signal-to-noise ratio (mean over examples, dB).

    Args:
        zero_mean: mean-center both signals over time before the ratio.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> snr = SNR(device="cpu")
        >>> round(float(snr(preds, target)), 4)
        16.1805
    """

    def __init__(
        self,
        zero_mean: bool = False,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )
        self.zero_mean = zero_mean

    def _per_example(self, preds: Tensor, target: Tensor) -> Tensor:
        return _snr_per_example(preds, target, self.zero_mean)
