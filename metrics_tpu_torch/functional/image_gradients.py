"""Image gradients by one-step finite differences. Counterpart of ``metrics_tpu/functional/image_gradients.py``."""
from typing import Tuple

import torch.nn.functional as F
from torch import Tensor


def _image_gradients_validate(img: Tensor) -> None:
    if not hasattr(img, "ndim"):
        raise TypeError(f"The `img` expects an array type but got {type(img)}")
    if img.ndim != 4:
        raise RuntimeError(f"The `img` expects a 4D tensor but got {img.ndim}D tensor")


def _compute_image_gradients(img: Tensor) -> Tuple[Tensor, Tensor]:
    dy = F.pad(img[..., 1:, :] - img[..., :-1, :], (0, 0, 0, 1))
    dx = F.pad(img[..., :, 1:] - img[..., :, :-1], (0, 1, 0, 0))
    return dy, dx


def image_gradients(img: Tensor) -> Tuple[Tensor, Tensor]:
    """(dy, dx) finite-difference gradients of an ``(N, C, H, W)`` image batch.

    Example:
        >>> import torch
        >>> image = torch.arange(0, 1*1*5*5, dtype=torch.float32).reshape(1, 1, 5, 5)
        >>> dy, dx = image_gradients(image)
        >>> dy[0, 0, :, :]
        tensor([[5., 5., 5., 5., 5.],
                [5., 5., 5., 5., 5.],
                [5., 5., 5., 5., 5.],
                [5., 5., 5., 5., 5.],
                [0., 0., 0., 0., 0.]])
    """
    _image_gradients_validate(img)
    return _compute_image_gradients(img)
