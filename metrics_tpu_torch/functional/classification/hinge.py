"""Hinge loss.

Counterpart of ``metrics_tpu/functional/classification/hinge.py``: a
streaming sum of losses and a count; the binary margin form and the
multiclass Crammer-Singer form, as ``sklearn.metrics.hinge_loss``.
"""
from typing import Tuple

import torch
from torch import Tensor


def _hinge_update(preds: Tensor, target: Tensor, squared: bool = False) -> Tuple[Tensor, int]:
    """(sum of per-sample hinge losses, sample count).

    ``preds``: (N,) binary decision values, or (N, C) multiclass scores.
    ``target``: (N,) labels in {0, 1} or {-1, +1} (binary), or [0, C) (multiclass).
    """
    if preds.ndim not in (1, 2):
        raise ValueError(f"`preds` must be (N,) decisions or (N, C) scores, got ndim={preds.ndim}")
    if target.shape != preds.shape[:1]:
        raise ValueError("`target` must be (N,) matching `preds`' leading dimension")
    if preds.ndim == 1:
        # both label conventions: {0, 1} and {-1, +1} (anything <= 0 is the negative class)
        y = torch.where(target.to(torch.float32) <= 0.0, -1.0, 1.0)
        margin = y * preds.to(torch.float32)
    else:
        scores = preds.to(torch.float32)
        idx = target.to(torch.int64)[:, None]
        true_score = torch.gather(scores, 1, idx)[:, 0]
        # Crammer-Singer: the margin against the best wrong class
        classes = torch.arange(scores.shape[1], device=scores.device)[None, :]
        masked = torch.where(classes == idx, float("-inf"), scores)
        margin = true_score - torch.max(masked, dim=1).values
    losses = torch.clamp_min(1.0 - margin, 0.0)
    if squared:
        losses = losses**2
    return torch.sum(losses), losses.shape[0]


def hinge_loss(preds: Tensor, target: Tensor, squared: bool = False) -> Tensor:
    """Mean (squared) hinge loss, as sklearn computes it.

    Example:
        >>> import torch
        >>> preds = torch.tensor([0.5, -1.5, 2.0])
        >>> target = torch.tensor([1, 0, 1])
        >>> round(float(hinge_loss(preds, target)), 4)
        0.1667
    """
    total, count = _hinge_update(preds, target, squared)
    return total / max(count, 1.0)
