"""Single-query normalized discounted cumulative gain (linear gain).

Counterpart of ``metrics_tpu/functional/retrieval/ndcg.py``.
"""
from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.retrieval.utils import descending_order


def retrieval_normalized_dcg(preds: Tensor, target: Tensor, k: Optional[int] = None) -> Tensor:
    """NDCG of one query: DCG in score order over DCG in the ideal order, linear gain.

    Example:
        >>> import torch
        >>> preds = torch.tensor([0.1, 0.9, 0.5])
        >>> target = torch.tensor([0, 1, 1])
        >>> round(float(retrieval_normalized_dcg(preds, target)), 4)
        1.0
    """
    if preds.shape != target.shape:
        raise ValueError("`preds` and `target` must have the same shape")
    k = target.shape[-1] if k is None else k
    if not isinstance(k, int) or k <= 0:
        raise ValueError("`k` has to be a positive integer or None")

    target = target.to(torch.float32)
    gains = target[descending_order(preds)][:k]
    discounts = 1.0 / torch.log2(torch.arange(gains.shape[0], dtype=torch.float32, device=target.device) + 2.0)
    dcg = torch.sum(gains * discounts)
    ideal_gains = torch.sort(target, descending=True).values[:k]
    idcg = torch.sum(ideal_gains * discounts)
    return torch.where(idcg == 0, 0.0, dcg / torch.where(idcg == 0, 1.0, idcg))
