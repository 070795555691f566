"""Dice score.

Counterpart of ``metrics_tpu/functional/classification/dice.py``: every class
at once with masks (no per-class loop), the ``bg`` skip, and the
``no_fg_score`` / ``nan_score`` substitutions.
"""
import torch
from torch import Tensor

from metrics_tpu_torch.utils.data import to_categorical
from metrics_tpu_torch.utils.reductions import reduce


def dice_score(
    pred: Tensor,
    target: Tensor,
    bg: bool = False,
    nan_score: float = 0.0,
    no_fg_score: float = 0.0,
    reduction: str = "elementwise_mean",
) -> Tensor:
    """Dice = 2·TP / (2·TP + FP + FN) per class.

    Example:
        >>> import torch
        >>> pred = torch.tensor([[0.85, 0.05, 0.05, 0.05],
        ...                      [0.05, 0.85, 0.05, 0.05],
        ...                      [0.05, 0.05, 0.85, 0.05],
        ...                      [0.05, 0.05, 0.05, 0.85]])
        >>> target = torch.tensor([0, 1, 3, 2])
        >>> round(float(dice_score(pred, target)), 4)
        0.3333
    """
    num_classes = pred.shape[1]
    start = 0 if bg else 1

    labels = to_categorical(pred) if pred.ndim == target.ndim + 1 else pred
    classes = torch.arange(start, num_classes, device=pred.device)

    pred_hits = labels.reshape(-1)[None, :] == classes[:, None]  # (C', M)
    target_hits = target.reshape(-1)[None, :] == classes[:, None]

    tp = torch.sum(pred_hits & target_hits, dim=1).to(torch.float32)
    fp = torch.sum(pred_hits & ~target_hits, dim=1).to(torch.float32)
    fn = torch.sum(~pred_hits & target_hits, dim=1).to(torch.float32)
    support = torch.sum(target_hits, dim=1)

    denom = 2 * tp + fp + fn
    scores = torch.where(denom == 0, nan_score, 2 * tp / torch.where(denom == 0, 1.0, denom))
    scores = torch.where(support == 0, no_fg_score, scores)  # no foreground pixels

    return reduce(scores, reduction=reduction)
