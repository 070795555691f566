"""The SSIM family's separable gaussian filter and per-pixel map: kernel K2 and its dispatch.

SSIM, MS-SSIM and UQI all filter the five moment maps ``(p, t, p^2, t^2, p*t)``
of an NCHW batch with a separable gaussian window and turn the filtered moments
into a per-pixel map. The plain version is ``functional/regression/ssim.py``
(``_moment_maps``, ``_ssim_map``) and ``uqi.py``: a reflect pad, a stacked
5-map tensor, one shifted multiply-add pass a tap along H and then along W,
the crop, and the pointwise ops.

* :func:`ssim_filter_cuda` wraps the hand-written CUDA kernel
  (``csrc/ssim_filter.cu``), one launch per call: it takes CUDA tensors only,
  launches on the current stream, never synchronises, reads ``data_range``
  and UQI's ``shift`` through device pointers, and counts its launches in
  ``ssim_filter_cuda.launches``. The plain version, run on CUDA tensors,
  counts its calls in ``ssim_filter_cuda.plain_cuda_calls``; together they
  give the kernel's hit share on the card.
* :func:`filter_takes` is the dispatch rule, a function of device, dtype,
  shape and window: a CUDA float32 batch whose window sides are at most
  :data:`MAX_SIDE` and whose maps are not empty runs the kernel; CPU tensors,
  other dtypes and larger windows run the plain version.
* :func:`launch_plan` is the kernel's grid as the caller sees it: one block per
  32 x 32 output tile of one (image, channel) plane, the partial sums laid out
  ``[maps][N][C * tiles_h * tiles_w]``. What a block stages and where in shared
  memory is the kernel's own; it checks the output's size against its grid.
"""
import ctypes
from typing import Dict, Optional, Sequence, Union

import torch
from torch import Tensor

from metrics_tpu_torch.ops.build import KERNELS

TILE_H = 32  # the kernel's output tile (csrc/ssim_filter.cu kTileH, kTileW)
TILE_W = 32
MAX_SIDE = 31  # longest window side the kernel's shared-memory plan takes


def launch_plan(shape: Sequence[int], kernel_size: Sequence[int]) -> Dict[str, object]:
    """The kernel's grid for an ``(N, C, H, W)`` batch and a ``(kh, kw)`` window:
    output extent, tiles, halo, blocks, and the ``(N, blocks_per_image)`` layout
    of each map's partial sums."""
    n, c, h, w = shape
    kh, kw = kernel_size
    out_h, out_w = h - kh + 1, w - kw + 1
    tiles_h, tiles_w = -(-out_h // TILE_H), -(-out_w // TILE_W)
    return {
        "out_h": out_h, "out_w": out_w, "tiles_h": tiles_h, "tiles_w": tiles_w, "halo": (kh - 1, kw - 1),
        "blocks": n * c * tiles_h * tiles_w, "partials": (n, c * tiles_h * tiles_w),
    }


def filter_takes(device: Union[str, torch.device], dtype: torch.dtype, shape: Sequence[int],
                 kernel_size: Sequence[int]) -> bool:
    """Whether K2 takes this batch: CUDA, float32, NCHW with ``N * C > 0``, each
    window side at most :data:`MAX_SIDE` and no longer than the image's."""
    if torch.device(device).type != "cuda" or dtype != torch.float32 or len(shape) != 4:
        return False
    n, c, h, w = shape
    kh, kw = kernel_size
    return max(kh, kw) <= MAX_SIDE and n * c > 0 and h >= kh and w >= kw


def _library() -> ctypes.CDLL:
    lib = KERNELS.load("ssim_filter")
    if lib.mtt_ssim_filter.argtypes is None:
        p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        lib.mtt_ssim_filter.argtypes = [p, p, ll, i, i, i, i, p, i, i, f, f, f, f, p, p, p, ll, i, p]
        lib.mtt_ssim_filter.restype = i
    return lib


def _device_scalar(x: Tensor, name: str, device: torch.device) -> Tensor:
    if x.numel() != 1 or x.dtype != torch.float32 or x.device != device:
        raise ValueError(f"ssim_filter_cuda takes `{name}` as one float32 value on the images' device")
    return x.reshape(())


def ssim_filter_cuda(
    preds: Tensor,
    target: Tensor,
    taps_h: Sequence[float],
    taps_w: Sequence[float],
    *,
    data_range: Optional[Union[float, Tensor]] = None,
    k1: float = 0.01,
    k2: float = 0.03,
    shift: Optional[Tensor] = None,
    maps: bool = False,
) -> Tensor:
    """Kernel K2: the filtered moments of an ``(N, C, H, W)`` batch turned into
    SSIM's or UQI's per-pixel values, over the valid extent
    ``(H - kh + 1, W - kw + 1)`` (the plain version's cropped maps).

    ``taps_h`` / ``taps_w`` are the float32 window along H / W (``_gaussian``),
    odd lengths of at most :data:`MAX_SIDE`. Without ``shift``: SSIM, with
    ``c = (k * data_range) ** 2`` from a number, or from a one-value float32
    tensor on the card, read there. With ``shift`` (one float32 value on the
    card): UQI on ``preds - shift`` and ``target - shift``.

    Returns ``maps=True``: the maps, ``(M, N, C, H - kh + 1, W - kw + 1)``;
    else each block's sums of them, ``(M, N, blocks_per_image)`` (see
    :func:`launch_plan`). ``M`` is 2 for SSIM (``ssim_idx``, ``cs_idx``) and
    1 for UQI. Inputs are contiguous float32 of one shape on one CUDA device;
    raises on anything else before any launch, and when the launch fails.
    """
    if preds.ndim != 4 or preds.shape != target.shape:
        raise ValueError("ssim_filter_cuda takes two NCHW batches of one shape")
    if preds.dtype != torch.float32 or target.dtype != torch.float32:
        raise ValueError(f"ssim_filter_cuda takes float32 images, got {preds.dtype}/{target.dtype}")
    if not (preds.is_contiguous() and target.is_contiguous()):
        raise ValueError("ssim_filter_cuda takes contiguous images")
    kh, kw = len(taps_h), len(taps_w)
    n, c, h, w = preds.shape
    if kh % 2 == 0 or kw % 2 == 0 or max(kh, kw) > MAX_SIDE or h < kh or w < kw or n * c == 0:
        raise ValueError(f"ssim_filter_cuda does not take a {kh} x {kw} window over {h} x {w} images"
                         f" ({n * c} planes): odd sides of at most {MAX_SIDE}, no longer than the image's")
    c1 = c2 = 0.0
    dr_ptr = shift_ptr = None
    if shift is not None:
        if data_range is not None:
            raise ValueError("ssim_filter_cuda's UQI form (shift given) takes no data_range")
        shift = _device_scalar(shift, "shift", preds.device)
        shift_ptr = shift.data_ptr()
    elif isinstance(data_range, Tensor):
        data_range = _device_scalar(data_range, "data_range", preds.device)
        dr_ptr = data_range.data_ptr()
    elif data_range is not None:
        c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2  # Python floats, as the plain version's scalars
    else:
        raise ValueError("ssim_filter_cuda's SSIM form needs a data_range")
    if not preds.is_cuda or target.device != preds.device:
        raise ValueError("ssim_filter_cuda takes CUDA tensors on one device")

    plan = launch_plan(preds.shape, (kh, kw))
    m = 1 if shift is not None else 2
    shape = (m, n, c, plan["out_h"], plan["out_w"]) if maps else (m, *plan["partials"])
    out = torch.empty(shape, dtype=torch.float32, device=preds.device)  # the kernel writes every element
    taps = (ctypes.c_float * (kh + kw))(*taps_h, *taps_w)
    device = preds.get_device()
    stream = torch._C._cuda_getCurrentRawStream(device)  # the raw handle, without a Stream object
    err = _library().mtt_ssim_filter(
        preds.data_ptr(), target.data_ptr(), n * c, h, w, kh, kw, ctypes.addressof(taps), int(shift is not None),
        int(maps), c1, c2, k1, k2, dr_ptr, shift_ptr, out.data_ptr(), out.numel(), device, stream,
    )
    if err != 0:
        raise RuntimeError(f"ssim_filter kernel launch failed with CUDA error {err}")
    ssim_filter_cuda.launches += 1
    return out


ssim_filter_cuda.launches = 0
ssim_filter_cuda.plain_cuda_calls = 0
