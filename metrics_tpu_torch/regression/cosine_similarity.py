"""CosineSimilarity module. Counterpart of ``metrics_tpu/regression/cosine_similarity.py``.

With ``'mean'`` / ``'sum'`` it keeps two ``"sum"`` states; ``'none'`` keeps a
list state ``sims`` of per-row similarities (a PaddedBuffer with ``capacity``).
"""
from typing import Any, Callable, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.regression.cosine_similarity import _cosine_similarity_rows
from metrics_tpu_torch.parallel.buffer import as_values


class CosineSimilarity(Metric):
    r"""Accumulated per-row cosine similarity.

    Example:
        >>> import torch
        >>> preds = torch.tensor([[1.0, 0.0], [1.0, 1.0]])
        >>> target = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
        >>> cos = CosineSimilarity(device="cpu")
        >>> round(float(cos(preds, target)), 4)
        0.8536
    """

    def __init__(
        self,
        reduction: str = "mean",
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        capacity: Optional[int] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(compute_on_step=compute_on_step, dist_sync_on_step=dist_sync_on_step,
                         process_group=process_group, dist_sync_fn=dist_sync_fn, device=device, capacity=capacity)
        if reduction not in ("mean", "sum", "none", None):
            raise ValueError(f"Expected reduction to be one of 'mean', 'sum', 'none', got {reduction}")
        self.reduction = reduction
        if reduction in ("mean", "sum"):
            self.add_state("sim_sum", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
            self.add_state("n_total", default=torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")
        else:
            self.add_state("sims", default=[], dist_reduce_fx=None, item_shape=())

    def update(self, preds: Tensor, target: Tensor) -> None:
        sim = _cosine_similarity_rows(preds, target)
        if self.reduction in ("mean", "sum"):
            self.sim_sum = self.sim_sum + torch.sum(sim)
            self.n_total = self.n_total + sim.shape[0]
        else:
            self._append("sims", sim)

    def compute(self) -> Tensor:
        if self.reduction == "sum":
            return self.sim_sum
        if self.reduction == "mean":
            return self.sim_sum / torch.clamp_min(self.n_total.to(torch.float32), 1.0)
        return as_values(self.sims)
