"""Structural similarity (SSIM).

Counterpart of ``metrics_tpu/functional/regression/ssim.py``. The gaussian
window is separable, so the five moment maps (p, t, p^2, t^2, p*t, stacked
into one batch) are filtered by two 1-D passes, along H and then along W,
with valid extent after a reflect pad.

Each pass is K shifted multiply-adds in the input's dtype (:func:`_filter_1d`),
not a library convolution: on the card ``F.conv2d`` may run in TF32 under the
user's ``torch.backends.cudnn.allow_tf32`` (true by default), and the moment
maps cannot take that: ``var = E[x^2] - mu^2`` cancels, which is why the JAX
package runs its convolution at ``Precision.HIGHEST``. The multiply-adds use
no matmul and no cuDNN, so the result does not depend on any precision flag.

``F.pad(mode="reflect")`` excludes the edge pixel, as ``jnp.pad`` does (scipy's
``ndimage`` calls that mode ``mirror``).

On the card a float32 batch whose window fits takes kernel K2 instead
(``ops/ssim_filter.py``, :func:`filter_takes`): one launch gives the cropped
maps, or each block's sums of them, with the five moment maps never written to
device memory. Everything else, CPU tensors included, takes the plain version.
"""
import functools
from typing import Callable, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import Tensor

from metrics_tpu_torch.ops.ssim_filter import filter_takes, ssim_filter_cuda
from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.reductions import reduce


def _gaussian(kernel_size: int, sigma: float, dtype: torch.dtype) -> Tensor:
    """The normalized 1-D gaussian window, on the CPU."""
    dist = torch.arange((1 - kernel_size) / 2, (1 + kernel_size) / 2, 1, dtype=dtype)
    gauss = torch.exp(-((dist / sigma) ** 2) / 2)
    return gauss / torch.sum(gauss)


def _filter_1d(x: Tensor, window: Tensor, dim: int) -> Tensor:
    """Valid correlation of ``x`` with a 1-D window along ``dim``: K shifted
    multiply-adds, in the order of the taps."""
    taps = window.tolist()  # a CPU tensor: no device read
    size = x.shape[dim] - len(taps) + 1
    out = x.narrow(dim, 0, size) * taps[0]
    for k in range(1, len(taps)):
        out.add_(x.narrow(dim, k, size), alpha=taps[k])
    return out


@functools.lru_cache(maxsize=64)
def _window_taps(kernel_size: Tuple[int, int], sigma: Tuple[float, float]) -> Tuple[Tuple[float, ...], ...]:
    """K2's float32 taps along H and along W, the plain version's ``_gaussian`` values."""
    return tuple(tuple(_gaussian(k, s, torch.float32).tolist()) for k, s in zip(kernel_size, sigma))


def _on_kernel(preds: Tensor, kernel_size: Sequence[int]) -> bool:
    return filter_takes(preds.device, preds.dtype, preds.shape, kernel_size)


def _map_numel(shape: Sequence[int], kernel_size: Sequence[int]) -> int:
    """Pixels of the cropped map of a ``(..., H, W)`` batch (none where the window is the longer)."""
    *lead, h, w = shape
    count = max(h - kernel_size[0] + 1, 0) * max(w - kernel_size[1] + 1, 0)
    for d in lead:
        count *= d
    return count


def _filtered(preds: Tensor, target: Tensor, kernel_size: Sequence[int], sigma: Sequence[float], maps: bool,
              **kw) -> Tensor:
    """K2 over the batch: its maps or its per-block sums (``ssim_filter_cuda``)."""
    taps_h, taps_w = _window_taps(tuple(kernel_size), tuple(sigma))
    return ssim_filter_cuda(preds.contiguous(), target.contiguous(), taps_h, taps_w, maps=maps, **kw)


def _reduce_filtered(filtered: Callable[[bool], Tensor], count: int, reduction: str) -> Tensor:
    """``reduce`` of K2's first map: from its per-block sums for a mean or a sum, else from the map."""
    if reduction in ("elementwise_mean", "sum"):
        total = filtered(False)[0].sum()
        return total if reduction == "sum" else total / count
    return reduce(filtered(True)[0], reduction)


def _dtype_name(x: Tensor) -> str:
    return str(x.dtype).replace("torch.", "")  # numpy's spelling, as the JAX package's message has it


def _ssim_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    if preds.dtype != target.dtype:
        raise TypeError(
            "Expected `preds` and `target` to have the same data type."
            f" Got pred: {_dtype_name(preds)} and target: {_dtype_name(target)}."
        )
    _check_same_shape(preds, target)
    if len(preds.shape) != 4:
        raise ValueError(
            "Expected `preds` and `target` to have BxCxHxW shape."
            f" Got pred: {tuple(preds.shape)} and target: {tuple(target.shape)}."
        )
    return preds, target


def _check_ssim_params(kernel_size: Sequence[int], sigma: Sequence[float]) -> None:
    if len(kernel_size) != 2 or len(sigma) != 2:
        raise ValueError(
            "Expected `kernel_size` and `sigma` to have the length of two."
            f" Got kernel_size: {len(kernel_size)} and sigma: {len(sigma)}."
        )
    if any(x % 2 == 0 or x <= 0 for x in kernel_size):
        raise ValueError(f"Expected `kernel_size` to have odd positive number. Got {kernel_size}.")
    if any(y <= 0 for y in sigma):
        raise ValueError(f"Expected `sigma` to have positive number. Got {sigma}.")


def _moment_maps(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int],
    sigma: Sequence[float],
) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """Border-cropped windowed moments ``(mu_p, mu_t, var_p, var_t, cov)``.

    ``kernel_size[0]`` / ``sigma[0]`` act along H and ``[1]`` along W; the pad
    and the final crop use the same per-axis extents, so a non-square window
    stays centred. Shared by SSIM, MS-SSIM and UQI.
    """
    if preds.is_cuda:
        ssim_filter_cuda.plain_cuda_calls += 1
    pad_h = (kernel_size[0] - 1) // 2
    pad_w = (kernel_size[1] - 1) // 2
    preds_p = F.pad(preds, (pad_w, pad_w, pad_h, pad_h), mode="reflect")
    target_p = F.pad(target, (pad_w, pad_w, pad_h, pad_h), mode="reflect")
    stacked = torch.cat((preds_p, target_p, preds_p * preds_p, target_p * target_p, preds_p * target_p))
    outputs = _filter_1d(_filter_1d(stacked, _gaussian(kernel_size[0], sigma[0], preds.dtype), 2),
                         _gaussian(kernel_size[1], sigma[1], preds.dtype), 3)
    h, w = outputs.shape[-2:]
    # drop the border ring the reflection reached (the reference's final crop)
    outputs = outputs[..., pad_h:h - pad_h, pad_w:w - pad_w]
    mu_p, mu_t, e_pp, e_tt, e_pt = outputs.chunk(5)
    return mu_p, mu_t, e_pp - mu_p**2, e_tt - mu_t**2, e_pt - mu_p * mu_t


def _ssim_map(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int],
    sigma: Sequence[float],
    data_range: Union[float, Tensor],
    k1: float,
    k2: float,
) -> Tuple[Tensor, Tensor]:
    """Border-cropped per-pixel (SSIM, contrast-sensitivity) maps."""
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    mu_p, mu_t, var_p, var_t, cov = _moment_maps(preds, target, kernel_size, sigma)
    cs_idx = (2 * cov + c2) / (var_p + var_t + c2)  # contrast sensitivity, MS-SSIM's per-scale term
    ssim_idx = ((2 * mu_p * mu_t + c1) / (mu_p**2 + mu_t**2 + c1)) * cs_idx
    return ssim_idx, cs_idx


def _ssim_filtered(preds: Tensor, target: Tensor, kernel_size: Sequence[int], sigma: Sequence[float],
                   data_range: Union[float, Tensor], k1: float, k2: float, maps: bool) -> Tensor:
    """K2's SSIM form: ``(ssim_idx, cs_idx)`` maps, or their per-block sums ``(2, N, blocks)``. A tensor
    ``data_range`` is read on the card, as one float32 value."""
    if isinstance(data_range, Tensor):
        data_range = data_range.to(device=preds.device, dtype=torch.float32)
    return _filtered(preds, target, kernel_size, sigma, maps, data_range=data_range, k1=k1, k2=k2)


def _data_range_of(preds: Tensor, target: Tensor) -> Tensor:
    """The range inferred when ``data_range`` is None: the larger of the two inputs' spans."""
    return torch.maximum(torch.max(preds) - torch.min(preds), torch.max(target) - torch.min(target))


def _ssim_compute(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: str = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
) -> Tensor:
    _check_ssim_params(kernel_size, sigma)
    if data_range is None:
        data_range = _data_range_of(preds, target)
    if _on_kernel(preds, kernel_size):
        return _reduce_filtered(
            lambda maps: _ssim_filtered(preds, target, kernel_size, sigma, data_range, k1, k2, maps),
            _map_numel(preds.shape, kernel_size), reduction)
    ssim_idx, _ = _ssim_map(preds, target, kernel_size, sigma, data_range, k1, k2)
    return reduce(ssim_idx, reduction)


def ssim(
    preds: Tensor,
    target: Tensor,
    kernel_size: Sequence[int] = (11, 11),
    sigma: Sequence[float] = (1.5, 1.5),
    reduction: str = "elementwise_mean",
    data_range: Optional[float] = None,
    k1: float = 0.01,
    k2: float = 0.03,
) -> Tensor:
    """SSIM between two batches of NCHW images.

    Example:
        >>> import torch
        >>> target = torch.arange(0, 16 * 16, dtype=torch.float32).reshape(1, 1, 16, 16) / 256
        >>> preds = target * 0.75
        >>> round(float(ssim(preds, target)), 4)
        0.924
    """
    preds, target = _ssim_update(preds, target)
    return _ssim_compute(preds, target, kernel_size, sigma, reduction, data_range, k1, k2)
