"""Universal Image Quality Index (Wang & Bovik 2002).

Counterpart of ``metrics_tpu/functional/regression/uqi.py``: SSIM without its
stabilizers (``C1 = C2 = 0``), on the shared moment maps. Both signals are
centred on their shared global mean first, so ``E[x^2] - mu^2`` cancels at the
scale of the true variance, and a flat window is one whose variance is below
a few ulps of its centred second moment. Two flat windows agree in contrast
(the luminance term then scores their levels); both-zero means score 1.
On the card a float32 batch whose window fits takes kernel K2
(``ops/ssim_filter.py``), which subtracts the shift as it loads and applies
the same formulas per pixel.
"""
from typing import Sequence

import torch
from torch import Tensor

from metrics_tpu_torch.functional.regression.ssim import (
    _check_ssim_params,
    _filtered,
    _map_numel,
    _moment_maps,
    _on_kernel,
    _reduce_filtered,
    _ssim_update,
)
from metrics_tpu_torch.utils.reductions import reduce

_TINY = 1e-30  # guards the division of the branch that ``where`` drops


def _uqi_map(preds: Tensor, target: Tensor, kernel_size: Sequence[int], sigma: Sequence[float],
             shift: Tensor) -> Tensor:
    """The plain version's per-window quality map of the two batches centred on ``shift``."""
    mu_pc, mu_tc, var_p, var_t, cov = _moment_maps(preds - shift, target - shift, kernel_size, sigma)
    mu_p, mu_t = mu_pc + shift, mu_tc + shift

    denom_v = var_p + var_t
    denom_m = mu_p**2 + mu_t**2
    second_c = var_p + mu_pc**2 + var_t + mu_tc**2  # centred second moments
    flat = denom_v <= 64.0 * torch.finfo(preds.dtype).eps * second_c + _TINY
    one = torch.ones_like(denom_v)
    contrast = torch.where(flat, one, 2.0 * cov / torch.clamp_min(denom_v, _TINY))
    luminance = torch.where(denom_m <= _TINY, one, 2.0 * mu_p * mu_t / torch.clamp_min(denom_m, _TINY))
    return contrast * luminance


def universal_image_quality_index(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: str = "elementwise_mean",
) -> Tensor:
    """UQI between two batches of NCHW images:
    ``Q = (2 cov / (var_p + var_t)) * (2 mu_p mu_t / (mu_p^2 + mu_t^2))`` per window.

    Example:
        >>> import torch
        >>> target = torch.arange(0, 16 * 16, dtype=torch.float32).reshape(1, 1, 16, 16) / 256
        >>> preds = target * 0.75
        >>> round(float(universal_image_quality_index(preds, target)), 4)
        0.9216
    """
    preds, target = _ssim_update(preds, target)
    _check_ssim_params(kernel_size, sigma)
    shift = torch.mean((preds + target) * 0.5)
    if _on_kernel(preds, kernel_size):
        return _reduce_filtered(lambda maps: _filtered(preds, target, kernel_size, sigma, maps, shift=shift),
                                _map_numel(preds.shape, kernel_size), reduction)
    return reduce(_uqi_map(preds, target, kernel_size, sigma, shift), reduction)
