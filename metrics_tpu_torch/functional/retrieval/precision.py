"""Single-query retrieval precision at k.

Counterpart of ``metrics_tpu/functional/retrieval/precision.py``: hits within the
top-k ranked documents divided by ``k`` (``k=None``: the whole query).
"""
from typing import Optional

from torch import Tensor

from metrics_tpu_torch.functional.retrieval.utils import check_retrieval_inputs, check_topk, topk_hits


def retrieval_precision(preds: Tensor, target: Tensor, k: Optional[int] = None) -> Tensor:
    """Fraction of the top-k ranked documents that are relevant.

    Example:
        >>> import torch
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, True])
        >>> float(retrieval_precision(preds, target, k=2))
        0.5
    """
    check_retrieval_inputs(preds, target)
    check_topk(k)
    hits, _, k_eff = topk_hits(preds, target, k)
    return hits / k_eff
