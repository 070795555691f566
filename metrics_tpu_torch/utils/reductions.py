"""Score reduction helpers.

Counterpart of ``metrics_tpu/utils/reductions.py``: ``reduce`` and
``class_reduce``.
"""
import torch
from torch import Tensor


def reduce(to_reduce: Tensor, reduction: str) -> Tensor:
    """Reduce a tensor: ``'elementwise_mean'`` | ``'sum'`` | ``'none'``/None."""
    if reduction == "elementwise_mean":
        return torch.mean(to_reduce)
    if reduction == "none" or reduction is None:
        return to_reduce
    if reduction == "sum":
        return torch.sum(to_reduce)
    raise ValueError("Reduction parameter unknown.")


def class_reduce(num: Tensor, denom: Tensor, weights: Tensor, class_reduction: str = "none") -> Tensor:
    """Reduce per-class scores ``num/denom``: micro | macro | weighted | none.
    A 0/0 entry becomes 0 in every mode."""
    valid_reduction = ("micro", "macro", "weighted", "none", None)
    fraction = torch.sum(num) / torch.sum(denom) if class_reduction == "micro" else num / denom
    fraction = torch.where(torch.isnan(fraction), torch.zeros_like(fraction), fraction)

    if class_reduction == "micro":
        return fraction
    if class_reduction == "macro":
        return torch.mean(fraction)
    if class_reduction == "weighted":
        return torch.sum(fraction * (weights / torch.sum(weights)))
    if class_reduction == "none" or class_reduction is None:
        return fraction
    raise ValueError(f"Reduction parameter {class_reduction} unknown. Choose between one of these: {valid_reduction}")
