"""Single-query fall-out at k.

Counterpart of ``metrics_tpu/functional/retrieval/fall_out.py``.
"""
from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.retrieval.utils import check_retrieval_inputs, check_topk, topk_mask_count


def retrieval_fall_out(preds: Tensor, target: Tensor, k: Optional[int] = None) -> Tensor:
    """Fraction of NON-relevant documents that rank in the top-k (0 if there are none).

    Example:
        >>> import torch
        >>> preds = torch.tensor([0.2, 0.3, 0.5])
        >>> target = torch.tensor([True, False, False])
        >>> float(retrieval_fall_out(preds, target, k=1))
        0.5
    """
    check_retrieval_inputs(preds, target)
    check_topk(k)
    false_topk, total_neg, _ = topk_mask_count(preds, (target <= 0).to(torch.float32), k)
    return torch.where(total_neg == 0, 0.0, false_topk / torch.clamp(total_neg, min=1.0))
