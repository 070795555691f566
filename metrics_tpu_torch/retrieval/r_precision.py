"""RetrievalRPrecision. Counterpart of ``metrics_tpu/retrieval/r_precision.py``."""
from typing import Optional

from torch import Tensor

from metrics_tpu_torch.functional.retrieval.segments import grouped_r_precision
from metrics_tpu_torch.retrieval.retrieval_metric import RetrievalMetric


class RetrievalRPrecision(RetrievalMetric):
    r"""Mean R-precision over queries (precision at each query's own relevant
    count R, the cutoff where precision equals recall).

    Example:
        >>> import torch
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, True])
        >>> rp = RetrievalRPrecision(device="cpu")
        >>> float(rp(indexes, preds, target))
        0.75
    """

    def _grouped_metric(
        self, dense_idx: Tensor, preds: Tensor, target: Tensor, num_queries: int, valid: Optional[Tensor] = None
    ) -> Tensor:
        return grouped_r_precision(dense_idx, preds, target, num_queries)
