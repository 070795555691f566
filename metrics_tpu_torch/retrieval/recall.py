"""RetrievalRecall (recall@k). Counterpart of ``metrics_tpu/retrieval/recall.py``."""
from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.retrieval.segments import grouped_topk_hits
from metrics_tpu_torch.retrieval.retrieval_metric import _RetrievalAtK


class RetrievalRecall(_RetrievalAtK):
    r"""Mean recall@k over queries: hits in the top-k over the query's relevant count.

    Example:
        >>> import torch
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> r1 = RetrievalRecall(k=1, device="cpu")
        >>> float(r1(indexes, preds, target))
        0.5
    """

    def _grouped_metric(
        self, dense_idx: Tensor, preds: Tensor, target: Tensor, num_queries: int, valid: Optional[Tensor] = None
    ) -> Tensor:
        hits, rel_total, _ = grouped_topk_hits(dense_idx, preds, target, num_queries, self.k, valid)
        return torch.where(rel_total == 0, 0.0, hits.to(torch.float32) / torch.clamp(rel_total, min=1).to(torch.float32))
