"""Signal-to-noise ratio. Counterpart of ``metrics_tpu/functional/audio/snr.py``.

Reductions over the trailing time axis in float32, batched over any leading
axes. The sums run in another order on the CPU, on the card and in XLA, so
values agree to a float32 rounding of a sum over the time axis, not bit for bit.
"""
import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape

_EPS = 1e-8


def _db_ratio(signal: Tensor, noise: Tensor) -> Tensor:
    """``10 log10(signal / noise)`` with both clamped to ``_EPS``."""
    return 10.0 * torch.log10(torch.clamp(signal, min=_EPS) / torch.clamp(noise, min=_EPS))


def _snr_per_example(preds: Tensor, target: Tensor, zero_mean: bool) -> Tensor:
    """Per-example SNR in dB over the trailing axis (shape = leading axes)."""
    _check_same_shape(preds, target)
    preds = preds.to(torch.float32)
    target = target.to(torch.float32)
    if zero_mean:
        preds = preds - torch.mean(preds, dim=-1, keepdim=True)
        target = target - torch.mean(target, dim=-1, keepdim=True)
    signal = torch.sum(target**2, dim=-1)
    noise = torch.sum((preds - target) ** 2, dim=-1)
    return _db_ratio(signal, noise)


def signal_noise_ratio(preds: Tensor, target: Tensor, zero_mean: bool = False) -> Tensor:
    """SNR in dB, per example over the trailing axis, averaged over the batch.

    ``SNR = 10 log10( ||target||^2 / ||preds - target||^2 )``; with
    ``zero_mean`` both signals are mean-centered over time first.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(signal_noise_ratio(preds, target)), 4)
        16.1805
    """
    return torch.mean(_snr_per_example(preds, target, zero_mean))
