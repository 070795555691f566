"""Shared base for per-example dB audio metrics. Counterpart of ``metrics_tpu/audio/base.py``.

Every metric in this family reduces each example's trailing (time) axis to a
scalar in dB and reports the mean over all examples seen: a float32
``sum_db`` and an int64 ``n_examples``, both ``"sum"`` states, so a rank
sync is one ``all_reduce`` per dtype.
"""
from typing import Any, Callable, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.utils.data import accum_int_dtype


class _PerExampleDbMetric(Metric):

    def __init__(
        self,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )
        self.add_state("sum_db", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("n_examples", default=torch.zeros((), dtype=accum_int_dtype()), dist_reduce_fx="sum")

    def _per_example(self, preds: Tensor, target: Tensor) -> Tensor:
        raise NotImplementedError  # pragma: no cover - subclasses define it

    def update(self, preds: Tensor, target: Tensor) -> None:
        values = self._per_example(preds, target)
        self.sum_db = self.sum_db + torch.sum(values)
        self.n_examples = self.n_examples + values.numel()

    def compute(self) -> Tensor:
        return self.sum_db / torch.clamp_min(self.n_examples, 1).to(torch.float32)
