"""RetrievalMAP. Counterpart of ``metrics_tpu/retrieval/mean_average_precision.py``."""
from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.functional.retrieval.segments import grouped_average_precision
from metrics_tpu_torch.retrieval.retrieval_metric import RetrievalMetric


class RetrievalMAP(RetrievalMetric):
    r"""Mean average precision over queries.

    Example:
        >>> import torch
        >>> indexes = torch.tensor([0, 0, 0, 1, 1, 1, 1])
        >>> preds = torch.tensor([0.2, 0.3, 0.5, 0.1, 0.3, 0.5, 0.2])
        >>> target = torch.tensor([False, False, True, False, True, False, False])
        >>> map = RetrievalMAP(device="cpu")
        >>> float(map(indexes, preds, target))
        0.75
        >>> float(map.compute())
        0.75
    """

    def _grouped_metric(
        self, dense_idx: Tensor, preds: Tensor, target: Tensor, num_queries: int, valid: Optional[Tensor] = None
    ) -> Tensor:
        ap, _ = grouped_average_precision(dense_idx, preds, target.to(torch.bool), num_queries)
        return ap
