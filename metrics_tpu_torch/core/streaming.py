"""Streaming metric base: sum / count.

Counterpart of :class:`SumCountMetric` in ``metrics_tpu/core/streaming.py``,
the base of the metrics that reduce to "sum of per-sample statistics divided
by a count": a float32 ``total`` and an int64 ``count``, both "sum" states.
The windowed-serving math of that module is not ported yet.
"""
import inspect
from typing import Any, Callable, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric


class SumCountMetric(Metric):
    """``compute() = _finalize(total / max(count, 1))`` over streaming sum states.

    Subclasses implement ``_update_stats(*args, **kwargs) -> (sum, count)``
    (count may be an int or an integer tensor) and optionally
    ``_finalize(mean) -> value``.
    """

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
        self.add_state("total", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("count", default=torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")

    def _wrap_methods(self) -> None:
        super()._wrap_methods()
        # ``update`` forwards everything to ``_update_stats``: filter a collection's keyword
        # arguments by what that takes, so a member that reads ``img=`` can share the call
        self._update_signature = inspect.signature(self._update_stats)

    def _update_stats(self, *args: Any, **kwargs: Any) -> Tuple[Tensor, Any]:
        raise NotImplementedError  # pragma: no cover - subclasses define it

    def _finalize(self, mean: Tensor) -> Tensor:
        return mean

    def update(self, *args: Any, **kwargs: Any) -> None:
        total, count = self._update_stats(*args, **kwargs)
        self.total = self.total + total
        self.count = self.count + count

    def compute(self) -> Tensor:
        return self._finalize(self.total / torch.clamp_min(self.count, 1).to(torch.float32))
