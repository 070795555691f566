"""Multi-scale SSIM (Wang et al. 2003).

Counterpart of ``metrics_tpu/functional/regression/ms_ssim.py``: the SSIM maps
per scale, a 2 x 2 average pool between scales (``F.avg_pool2d``, which drops
an odd trailing row or column as the JAX package's VALID window does), the
per-image mean contrast sensitivity of the first S - 1 scales and the mean
SSIM of the coarsest, combined as ``prod_i relu(mcs_i)^beta_i * relu(mssim_S)^beta_S``.
On the card each scale is one launch of kernel K2 (``ops/ssim_filter.py``), whose
per-block sums give the per-image means; the pool stays a torch op.
"""
from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import Tensor

from metrics_tpu_torch.functional.regression.ssim import (
    _check_ssim_params,
    _data_range_of,
    _map_numel,
    _on_kernel,
    _ssim_filtered,
    _ssim_map,
    _ssim_update,
)
from metrics_tpu_torch.utils.reductions import reduce

# Wang et al. 2003 scale weights
_DEFAULT_BETAS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def multiscale_ssim(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: str = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    betas: Sequence[float] = _DEFAULT_BETAS,
) -> Tensor:
    """Multi-scale SSIM between two batches of NCHW images. The smaller side
    must satisfy ``(side >> (len(betas) - 1)) >= max(kernel_size)``.

    Example:
        >>> import torch
        >>> target = torch.arange(0, 96 * 96, dtype=torch.float32).reshape(1, 1, 96, 96) / (96 * 96)
        >>> preds = target * 0.75
        >>> round(float(multiscale_ssim(preds, target, kernel_size=(5, 5))), 4)
        0.9645
    """
    preds, target = _ssim_update(preds, target)
    _check_ssim_params(kernel_size, sigma)
    if len(betas) < 1:
        raise ValueError("`betas` must contain at least one scale weight")
    side = min(preds.shape[-2], preds.shape[-1])
    min_side = side >> (len(betas) - 1)
    if min_side < max(kernel_size):
        raise ValueError(
            f"image side {side} is too small for"
            f" {len(betas)} scales with kernel {tuple(kernel_size)}: the coarsest"
            f" scale would be {min_side} pixels"
        )
    if data_range is None:
        data_range = _data_range_of(preds, target)

    terms = []
    p, t = preds, target
    for scale, beta in enumerate(betas):
        last = scale == len(betas) - 1  # luminance enters at the coarsest scale only
        if _on_kernel(p, kernel_size):
            sums = _ssim_filtered(p, t, kernel_size, sigma, data_range, k1, k2, False)[0 if last else 1]
            value = sums.sum(dim=1) / _map_numel(p.shape[1:], kernel_size)
        else:
            ssim_idx, cs_idx = _ssim_map(p, t, kernel_size, sigma, data_range, k1, k2)
            value = torch.mean(ssim_idx if last else cs_idx, dim=(1, 2, 3))
        if not last:
            p, t = F.avg_pool2d(p, 2), F.avg_pool2d(t, 2)
        terms.append(torch.clamp_min(value, 0.0) ** beta)
    return reduce(torch.prod(torch.stack(terms), dim=0), reduction)
