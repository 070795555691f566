"""RetrievalNormalizedDCG. Counterpart of ``metrics_tpu/retrieval/ndcg.py`` (linear gain)."""
from typing import Optional

from torch import Tensor

from metrics_tpu_torch.functional.retrieval.segments import grouped_ndcg
from metrics_tpu_torch.retrieval.retrieval_metric import _RetrievalAtK


class RetrievalNormalizedDCG(_RetrievalAtK):
    r"""Mean NDCG over queries, graded targets as linear gains.

    Example:
        >>> import torch
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> ndcg = RetrievalNormalizedDCG(device="cpu")
        >>> round(float(ndcg(indexes, preds, target)), 4)
        0.8467
    """

    def _grouped_metric(
        self, dense_idx: Tensor, preds: Tensor, target: Tensor, num_queries: int, valid: Optional[Tensor] = None
    ) -> Tensor:
        return grouped_ndcg(dense_idx, preds, target, num_queries, k=self.k)
