"""Single-query hit rate at k.

Counterpart of ``metrics_tpu/functional/retrieval/hit_rate.py``.
"""
from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.retrieval.utils import check_retrieval_inputs, check_topk, topk_hits


def retrieval_hit_rate(preds: Tensor, target: Tensor, k: Optional[int] = None) -> Tensor:
    """1.0 if any relevant document ranks in the top-k, else 0.0.

    Example:
        >>> import torch
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, False])
        >>> float(retrieval_hit_rate(preds, target, k=1))
        0.0
    """
    check_retrieval_inputs(preds, target)
    check_topk(k)
    hits, _, _ = topk_hits(preds, target, k)
    return (hits > 0).to(torch.float32)
