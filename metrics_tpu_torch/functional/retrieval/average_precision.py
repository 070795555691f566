"""Single-query retrieval average precision.

Counterpart of ``metrics_tpu/functional/retrieval/average_precision.py``: rows
sorted by descending score, the mean of (hits so far / position) over the
relevant rows.
"""
import torch
from torch import Tensor

from metrics_tpu_torch.functional.retrieval.utils import descending_order


def retrieval_average_precision(preds: Tensor, target: Tensor) -> Tensor:
    """AP of one query's predictions against binary relevance labels (0 with no relevant row).

    Example:
        >>> import torch
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> round(float(retrieval_average_precision(preds, target)), 4)
        0.8333
    """
    if preds.shape != target.shape:
        raise ValueError("`preds` and `target` must have the same shape and live on the same device")
    if target.is_floating_point() or target.is_complex():
        raise ValueError("`target` must be a tensor of booleans or integers")
    relevant = target.to(torch.bool)[descending_order(preds)]
    positions = torch.arange(1, relevant.shape[0] + 1, dtype=torch.float32, device=preds.device)
    hits = torch.cumsum(relevant.to(torch.int64), 0).to(torch.float32)
    n_rel = torch.sum(relevant)
    total = torch.sum(torch.where(relevant, hits / positions, 0.0))
    return torch.where(n_rel == 0, 0.0, total / torch.clamp(n_rel, min=1).to(torch.float32))
