"""RetrievalHitRate (hit rate@k). Counterpart of ``metrics_tpu/retrieval/hit_rate.py``."""
from typing import Optional

from torch import Tensor

from metrics_tpu_torch.functional.retrieval.segments import grouped_hit_rate
from metrics_tpu_torch.retrieval.retrieval_metric import _RetrievalAtK


class RetrievalHitRate(_RetrievalAtK):
    r"""Fraction of queries with at least one relevant document in the top-k.

    Example:
        >>> import torch
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> hr1 = RetrievalHitRate(k=1, device="cpu")
        >>> float(hr1(indexes, preds, target))
        0.5
    """

    def _grouped_metric(
        self, dense_idx: Tensor, preds: Tensor, target: Tensor, num_queries: int, valid: Optional[Tensor] = None
    ) -> Tensor:
        return grouped_hit_rate(dense_idx, preds, target, num_queries, self.k, valid)
