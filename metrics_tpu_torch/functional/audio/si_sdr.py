"""Scale-invariant SDR / SNR. Counterpart of ``metrics_tpu/functional/audio/si_sdr.py``.

Reductions over the trailing time axis in float32, batched over any leading
axes, with the JAX package's ``_EPS`` clamps.
"""
import torch
from torch import Tensor

from metrics_tpu_torch.functional.audio.snr import _EPS, _db_ratio
from metrics_tpu_torch.utils.checks import _check_same_shape


def _si_sdr_per_example(preds: Tensor, target: Tensor, zero_mean: bool) -> Tensor:
    """Per-example SI-SDR in dB over the trailing axis."""
    _check_same_shape(preds, target)
    preds = preds.to(torch.float32)
    target = target.to(torch.float32)
    if zero_mean:
        preds = preds - torch.mean(preds, dim=-1, keepdim=True)
        target = target - torch.mean(target, dim=-1, keepdim=True)
    alpha = torch.sum(preds * target, dim=-1, keepdim=True) / torch.clamp(
        torch.sum(target**2, dim=-1, keepdim=True), min=_EPS
    )
    scaled = alpha * target
    signal = torch.sum(scaled**2, dim=-1)
    noise = torch.sum((preds - scaled) ** 2, dim=-1)
    return _db_ratio(signal, noise)


def scale_invariant_signal_distortion_ratio(preds: Tensor, target: Tensor, zero_mean: bool = False) -> Tensor:
    """SI-SDR in dB, per example over the trailing axis, batch-averaged.

    The target is rescaled by ``alpha = <preds, target> / ||target||^2`` so
    the measure ignores overall gain:
    ``SI-SDR = 10 log10( ||alpha target||^2 / ||preds - alpha target||^2 )``.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(scale_invariant_signal_distortion_ratio(preds, target)), 4)
        18.403
    """
    return torch.mean(_si_sdr_per_example(preds, target, zero_mean))


def scale_invariant_signal_noise_ratio(preds: Tensor, target: Tensor) -> Tensor:
    """SI-SNR in dB: SI-SDR with both signals mean-centered over time.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(scale_invariant_signal_noise_ratio(preds, target)), 4)
        15.0918
    """
    return scale_invariant_signal_distortion_ratio(preds, target, zero_mean=True)
