"""RetrievalFallOut (fall-out@k). Counterpart of ``metrics_tpu/retrieval/fall_out.py``.

Fall-out is the false-positive analogue of recall: the fraction of
NON-relevant documents that rank in the top-k. The empty-query policy
(``query_without_relevant_docs``) therefore applies to queries with no
non-relevant documents, the inverse of the other retrieval metrics.
"""
from typing import Optional

from torch import Tensor

from metrics_tpu_torch.functional.retrieval.segments import grouped_fall_out, segment_sum
from metrics_tpu_torch.retrieval.retrieval_metric import _RetrievalAtK


class RetrievalFallOut(_RetrievalAtK):
    r"""Mean fall-out@k (non-relevant docs in the top-k over all non-relevant docs).

    Example:
        >>> import torch
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> fo1 = RetrievalFallOut(k=1, device="cpu")
        >>> float(fo1(indexes, preds, target))
        0.25
    """

    _EMPTY_QUERY_ERROR = "without non-relevant targets"

    def _empty_query_mask(self, dense_idx: Tensor, target: Tensor, exists: Tensor, num_queries: int) -> Tensor:
        # fall-out is undefined for queries with no NON-relevant valid rows
        valid_neg = (target <= 0) & (target != self.exclude)
        return (segment_sum(valid_neg, dense_idx, num_queries) == 0) & exists

    def _grouped_metric(
        self, dense_idx: Tensor, preds: Tensor, target: Tensor, num_queries: int, valid: Optional[Tensor] = None
    ) -> Tensor:
        return grouped_fall_out(dense_idx, preds, target, num_queries, self.k, valid)
