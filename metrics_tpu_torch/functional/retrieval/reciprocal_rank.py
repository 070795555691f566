"""Single-query reciprocal rank.

Counterpart of ``metrics_tpu/functional/retrieval/reciprocal_rank.py``.
"""
import torch
from torch import Tensor

from metrics_tpu_torch.functional.retrieval.utils import check_retrieval_inputs, descending_order


def retrieval_reciprocal_rank(preds: Tensor, target: Tensor) -> Tensor:
    """Reciprocal rank of the first relevant document (0 if none); graded targets count as relevant.

    Example:
        >>> import torch
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([False, True, False])
        >>> float(retrieval_reciprocal_rank(preds, target))
        0.5
    """
    check_retrieval_inputs(preds, target)
    sorted_t = (target > 0)[descending_order(preds)]
    ranks = torch.arange(1, sorted_t.shape[0] + 1, dtype=torch.float32, device=preds.device)
    first = torch.min(torch.where(sorted_t, ranks, float("inf")))
    return torch.where(torch.isfinite(first), 1.0 / torch.clamp(first, min=1.0), 0.0)
