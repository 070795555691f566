"""Anisotropic total variation of images. Counterpart of
``metrics_tpu/functional/regression/total_variation.py``."""
from typing import Tuple

import torch
from torch import Tensor


def _total_variation_update(img: Tensor) -> Tuple[Tensor, int]:
    if img.ndim != 4:
        raise ValueError(f"Expected img of shape (N, C, H, W), got {tuple(img.shape)}")
    img = img.to(torch.float32)
    dh = torch.abs(img[:, :, 1:, :] - img[:, :, :-1, :]).sum(dim=(1, 2, 3))
    dw = torch.abs(img[:, :, :, 1:] - img[:, :, :, :-1]).sum(dim=(1, 2, 3))
    return (dh + dw).sum(), img.shape[0]


def total_variation(img: Tensor, reduction: str = "sum") -> Tensor:
    """Sum of absolute differences between neighbouring pixels along H and W of
    ``(N, C, H, W)`` images: the batch total (``'sum'``) or the per-image mean (``'mean'``).

    Example:
        >>> import torch
        >>> img = torch.arange(16.0).reshape(1, 1, 4, 4)
        >>> float(total_variation(img))
        60.0
    """
    if reduction not in ("sum", "mean"):
        raise ValueError(f"Expected reduction to be 'sum' or 'mean', got {reduction}")
    score, n = _total_variation_update(img)
    if reduction == "mean":
        return score / max(n, 1)
    return score
