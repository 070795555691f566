"""Pairwise box IoU (xyxy format).

Counterpart of ``metrics_tpu/functional/detection/iou.py``: broadcast algebra
in float32, the same operations in the same order, so a pair whose corners are
exact in float32 gets the JAX package's value bit for bit.
"""
import torch
from torch import Tensor


def _check_boxes(name: str, boxes: Tensor) -> None:
    if boxes.ndim != 2 or boxes.shape[-1] != 4:
        raise ValueError(f"Expected {name} of shape (N, 4) xyxy, got {tuple(boxes.shape)}")


def _areas(boxes: Tensor) -> Tensor:
    """Areas of ``(..., 4)`` xyxy boxes; a negative extent counts as 0."""
    return torch.clamp(boxes[..., 2] - boxes[..., 0], min=0) * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0)


def _intersection(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """``(..., N, M)`` intersection areas of ``(..., N, 4)`` and ``(..., M, 4)`` boxes."""
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    return wh[..., 0] * wh[..., 1]


def _ratio(num: Tensor, den: Tensor) -> Tensor:
    """``num / den`` where ``den > 0``, else 0 (never NaN)."""
    pos = den > 0
    return torch.where(pos, num / torch.where(pos, den, torch.ones_like(den)), torch.zeros_like(num))


def _iou(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """Batched IoU ``(..., N, 4) x (..., M, 4) -> (..., N, M)``, float32 inputs."""
    inter = _intersection(boxes1, boxes2)
    union = _areas(boxes1)[..., :, None] + _areas(boxes2)[..., None, :] - inter
    return _ratio(inter, union)


def box_iou(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """Pairwise IoU of two xyxy box sets: ``(N, 4) x (M, 4) -> (N, M)``.

    Degenerate (zero-area) pairs give 0, not NaN.

    Example:
        >>> import torch
        >>> a = torch.tensor([[0.0, 0.0, 2.0, 2.0]])
        >>> b = torch.tensor([[1.0, 1.0, 3.0, 3.0], [0.0, 0.0, 2.0, 2.0]])
        >>> [round(float(v), 4) for v in box_iou(a, b)[0]]
        [0.1429, 1.0]
    """
    _check_boxes("boxes1", boxes1)
    _check_boxes("boxes2", boxes2)
    return _iou(boxes1.to(torch.float32), boxes2.to(torch.float32))


def generalized_box_iou(boxes1: Tensor, boxes2: Tensor) -> Tensor:
    """Pairwise GIoU (Rezatofighi et al. 2019): IoU minus the normalized
    empty area of the smallest enclosing box; range ``[-1, 1]``.

    Example:
        >>> import torch
        >>> a = torch.tensor([[0.0, 0.0, 1.0, 1.0]])
        >>> b = torch.tensor([[2.0, 2.0, 3.0, 3.0]])
        >>> round(float(generalized_box_iou(a, b)[0, 0]), 4)
        -0.7778
    """
    _check_boxes("boxes1", boxes1)
    _check_boxes("boxes2", boxes2)
    boxes1 = boxes1.to(torch.float32)
    boxes2 = boxes2.to(torch.float32)
    inter = _intersection(boxes1, boxes2)
    union = _areas(boxes1)[:, None] + _areas(boxes2)[None, :] - inter
    iou = _ratio(inter, union)
    lt = torch.minimum(boxes1[:, None, :2], boxes2[None, :, :2])
    rb = torch.maximum(boxes1[:, None, 2:], boxes2[None, :, 2:])
    wh = torch.clamp(rb - lt, min=0)
    enclose = wh[..., 0] * wh[..., 1]
    return iou - _ratio(enclose - union, enclose)
