"""SI-SDR / SI-SNR modules. Counterpart of ``metrics_tpu/audio/si_sdr.py``."""
from typing import Any, Callable, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.audio.base import _PerExampleDbMetric
from metrics_tpu_torch.functional.audio.si_sdr import _si_sdr_per_example


class SI_SDR(_PerExampleDbMetric):
    r"""Accumulated scale-invariant signal-to-distortion ratio (mean, dB).

    Args:
        zero_mean: mean-center both signals over time before scaling.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> si_sdr = SI_SDR(device="cpu")
        >>> round(float(si_sdr(preds, target)), 4)
        18.403
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
        return _si_sdr_per_example(preds, target, self.zero_mean)


class SI_SNR(_PerExampleDbMetric):
    r"""Accumulated scale-invariant signal-to-noise ratio (mean, dB).

    Equivalent to SI-SDR with both signals mean-centered over time.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> si_snr = SI_SNR(device="cpu")
        >>> round(float(si_snr(preds, target)), 4)
        15.0918
    """

    def _per_example(self, preds: Tensor, target: Tensor) -> Tensor:
        return _si_sdr_per_example(preds, target, zero_mean=True)
