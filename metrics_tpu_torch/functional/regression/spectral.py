"""Spectral image metrics: SAM and ERGAS, per image over NCHW batches.

Counterpart of ``metrics_tpu/functional/regression/spectral.py``.
"""

import torch
from torch import Tensor

from metrics_tpu_torch.functional.regression.ssim import _ssim_update
from metrics_tpu_torch.utils.reductions import reduce

_TINY = 1e-30

def _sam_per_image(preds: Tensor, target: Tensor) -> Tensor:
    """Mean spectral angle (radians) per image: for each pixel, the angle
    between its C-vectors. Both spectra zero agree (0); exactly one zero is pi/2."""
    dot = torch.sum(preds * target, dim=1)
    norm_p = torch.linalg.vector_norm(preds, dim=1)
    norm_t = torch.linalg.vector_norm(target, dim=1)
    cos = torch.clamp(dot / torch.clamp_min(norm_p * norm_t, _TINY), -1.0, 1.0)
    angle = torch.where((norm_p <= _TINY) & (norm_t <= _TINY), torch.zeros_like(cos), torch.arccos(cos))
    return torch.mean(angle, dim=(-2, -1))

def spectral_angle_mapper(preds: Tensor, target: Tensor, reduction: str = "elementwise_mean") -> Tensor:
    """SAM in radians between two NCHW batches (C = spectral bands).

    Example:
        >>> import torch
        >>> target = torch.stack([torch.ones((1, 8, 8)), torch.zeros((1, 8, 8))], dim=1)
        >>> preds = torch.stack([torch.ones((1, 8, 8)), torch.ones((1, 8, 8))], dim=1)
        >>> round(float(spectral_angle_mapper(preds, target)), 4)
        0.7854
    """
    preds, target = _ssim_update(preds, target)
    if preds.shape[1] < 2:
        raise ValueError(f"SAM needs at least 2 spectral bands (channels), got {preds.shape[1]}")
    return reduce(_sam_per_image(preds, target), reduction)

def _ergas_per_image(preds: Tensor, target: Tensor, ratio: float) -> Tensor:
    """ERGAS per image: ``100 ratio sqrt(mean_c(RMSE_c^2 / mean_c^2))``."""
    rmse_sq = torch.mean((preds - target) ** 2, dim=(-2, -1))  # (B, C)
    mean_sq = torch.mean(target, dim=(-2, -1)) ** 2
    return 100.0 * ratio * torch.sqrt(torch.mean(rmse_sq / torch.clamp_min(mean_sq, _TINY), dim=-1))

def error_relative_global_dimensionless_synthesis(
    preds: Tensor, target: Tensor, ratio: float = 4.0, reduction: str = "elementwise_mean"
) -> Tensor:
    """ERGAS (Wald 2000) between two NCHW batches, lower is better; ``ratio`` is
    the high / low spatial resolution ratio, conventionally 4.

    Example:
        >>> import torch
        >>> target = torch.ones((1, 2, 8, 8))
        >>> preds = target * 0.9
        >>> round(float(error_relative_global_dimensionless_synthesis(preds, target)), 4)
        40.0
    """
    preds, target = _ssim_update(preds, target)
    if ratio <= 0:
        raise ValueError(f"`ratio` must be positive, got {ratio!r}")
    return reduce(_ergas_per_image(preds, target, ratio), reduction)
