"""Single-query retrieval recall at k.

Counterpart of ``metrics_tpu/functional/retrieval/recall.py``: hits within the
top-k ranked documents divided by the number of relevant documents.
"""
from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.retrieval.utils import check_retrieval_inputs, check_topk, topk_hits


def retrieval_recall(preds: Tensor, target: Tensor, k: Optional[int] = None) -> Tensor:
    """Fraction of all relevant documents found in the top-k ranking (0 with none).

    Example:
        >>> import torch
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> float(retrieval_recall(preds, target, k=1))
        0.5
    """
    check_retrieval_inputs(preds, target)
    check_topk(k)
    hits, total, _ = topk_hits(preds, target, k)
    return torch.where(total == 0, 0.0, hits / torch.clamp(total, min=1.0))
