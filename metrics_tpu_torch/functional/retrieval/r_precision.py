"""Single-query R-precision.

Counterpart of ``metrics_tpu/functional/retrieval/r_precision.py``. R (the
query's relevant count) stays on the device as the rank cutoff: no host read.
"""
import torch
from torch import Tensor

from metrics_tpu_torch.functional.retrieval.utils import check_retrieval_inputs, mask_within_rank


def retrieval_r_precision(preds: Tensor, target: Tensor) -> Tensor:
    """Precision at R, where R is the query's own relevant count (0 with no relevant document).

    Example:
        >>> import torch
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1])
        >>> target = torch.tensor([True, False, True, False])
        >>> float(retrieval_r_precision(preds, target))
        0.5
    """
    check_retrieval_inputs(preds, target)
    rel = (target > 0).to(torch.float32)
    r = torch.sum(rel)
    hits = mask_within_rank(preds, rel, r)
    return torch.where(r == 0, 0.0, hits / torch.clamp(r, min=1.0))
