"""The least work of the SSIM family's update on a batch: SSIM, MS-SSIM and UQI.

Operations: the separable gaussian's multiply-adds (2 operations a tap) over
the five moment maps (p, t, p^2, t^2, p*t), two 1-D passes of ``kernel`` taps,
at every pixel of each scale the member filters (SSIM and UQI: the full size;
MS-SSIM: the full size and each 2 x 2 pooled scale after it). The pointwise
arithmetic around the filter is left out, so the count is a floor whatever
implements the filter.

Bytes: each member reads the batch's predictions and targets once (float32);
its output, one value, is left out.
"""
from typing import Dict, Sequence

MAPS = 5


def filtered_pixels(shape: Sequence[int], scales: int) -> int:
    n, c, h, w = shape
    return sum(n * c * (h >> s) * (w >> s) for s in range(scales))


def work(shape: Sequence[int], kernel: int = 11, ms_scales: int = 5, itemsize: int = 4) -> Dict[str, float]:
    per_pixel = MAPS * 2 * kernel * 2  # five maps, two passes, a multiply-add a tap
    flops = per_pixel * (2 * filtered_pixels(shape, 1) + filtered_pixels(shape, ms_scales))
    n, c, h, w = shape
    nbytes = 3 * 2 * n * c * h * w * itemsize
    return {"flops": float(flops), "bytes": float(nbytes)}


def bound_ms(shape: Sequence[int], peaks: Dict[str, float], **kw) -> Dict[str, float]:
    """The least time on the card, and which bound sets it."""
    wk = work(shape, **kw)
    compute_ms = wk["flops"] / peaks["fp32_flops"] * 1e3
    memory_ms = wk["bytes"] / peaks["hbm_bytes_s"] * 1e3
    return {"ms": max(compute_ms, memory_ms), "compute_ms": compute_ms, "memory_ms": memory_ms,
            "bound_by": "compute" if compute_ms >= memory_ms else "bytes"}
