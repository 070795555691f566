"""Input checks and the ranking rule shared by the single-query retrieval functionals.

Counterpart of ``metrics_tpu/functional/retrieval/utils.py``. The module layer
validates through ``RetrievalMetric`` and ``_validate_k`` instead.
"""
from typing import Optional, Tuple, Union

import torch
from torch import Tensor


def check_retrieval_inputs(preds: Tensor, target: Tensor) -> None:
    """Common ``(preds, target)`` validation for single-query functionals."""
    if preds.shape != target.shape:
        raise ValueError("`preds` and `target` must have the same shape")
    if target.is_floating_point() or target.is_complex():
        raise ValueError("`target` must be a tensor of booleans or integers")


def check_topk(k: Optional[int]) -> None:
    if k is not None and (not isinstance(k, int) or k <= 0):
        raise ValueError("`k` has to be a positive integer or None")


def descending_order(preds: Tensor) -> Tensor:
    """Row order by descending score, stable on ties, NaN scores last.

    The key ``-preds`` is made positive NaN where it is NaN: the card's radix
    sort orders a negative NaN first, the CPU sort orders every NaN last.
    """
    key = -preds.to(torch.float32)
    key = torch.where(torch.isnan(key), torch.full_like(key, float("nan")), key)
    return torch.argsort(key, stable=True)


def mask_within_rank(preds: Tensor, mask: Tensor, r: Union[int, Tensor]) -> Tensor:
    """Sum of ``mask`` over the rows ranked in the top ``r`` by descending score.

    The single-query ranking rule (descending score, stable on ties), the same
    as the grouped functions'. ``r`` may be an int or a 0-d tensor (R-precision's
    relevant count), read on the device.
    """
    ranks = torch.arange(mask.shape[0], dtype=torch.float32, device=mask.device)
    return torch.sum(torch.where(ranks < r, mask[descending_order(preds)], 0.0))


def topk_mask_count(preds: Tensor, mask: Tensor, k: Optional[int]) -> Tuple[Tensor, Tensor, int]:
    """(mask rows within the top-k, total mask rows, effective k); top-k is cut at the query's size."""
    n = mask.shape[0]
    k_eff = n if k is None else k
    return mask_within_rank(preds, mask, min(k_eff, n)), torch.sum(mask), k_eff


def topk_hits(preds: Tensor, target: Tensor, k: Optional[int]) -> Tuple[Tensor, Tensor, int]:
    """(hits within top-k, total relevant, effective k) for one query; graded targets count as one hit."""
    return topk_mask_count(preds, (target > 0).to(torch.float32), k)
