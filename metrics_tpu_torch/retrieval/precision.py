"""RetrievalPrecision (precision@k). Counterpart of ``metrics_tpu/retrieval/precision.py``."""
from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.retrieval.segments import grouped_topk_hits
from metrics_tpu_torch.retrieval.retrieval_metric import _RetrievalAtK


class RetrievalPrecision(_RetrievalAtK):
    r"""Mean precision@k over queries: hits in the top-k over k. With ``k=None``
    each query's own document count is its k.

    Example:
        >>> import torch
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> p2 = RetrievalPrecision(k=2, device="cpu")
        >>> float(p2(indexes, preds, target))
        0.5
    """

    def _grouped_metric(
        self, dense_idx: Tensor, preds: Tensor, target: Tensor, num_queries: int, valid: Optional[Tensor] = None
    ) -> Tensor:
        hits, _, n_valid = grouped_topk_hits(dense_idx, preds, target, num_queries, self.k, valid)
        denom = n_valid if self.k is None else torch.full_like(n_valid, self.k)
        return hits.to(torch.float32) / torch.clamp(denom, min=1).to(torch.float32)
