"""MinMaxMetric: a scalar metric with the lowest and highest of its computed values.

Counterpart of ``metrics_tpu/wrappers/minmax.py``.
"""
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric

__all__ = ["MinMaxMetric"]


class MinMaxMetric(Metric):
    r"""Track a scalar metric with the min / max of its computed values.

    ``compute()`` returns ``{"raw": current, "min": lowest yet, "max": highest
    yet}``. The extrema fold in every computed value, the batch values each
    ``forward`` yields as well as epoch ``compute()`` results, and carry
    ``min`` / ``max`` reductions for the cross-rank sync. A NaN value leaves
    them as they are.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy
        >>> m = MinMaxMetric(Accuracy(device="cpu"))
        >>> _ = m(torch.tensor([1, 1, 0, 0]), torch.tensor([1, 0, 0, 0]))
        >>> {k: round(float(v), 2) for k, v in sorted(m.compute().items())}
        {'max': 0.75, 'min': 0.75, 'raw': 0.75}
    """

    def __init__(
        self,
        base_metric: Metric,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
    ):
        if not isinstance(base_metric, Metric):
            raise ValueError(f"`base_metric` must be a Metric, got {type(base_metric).__name__}")
        super().__init__(
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=base_metric.device,
        )
        self.base_metric = base_metric
        self.add_state("min_val", default=torch.tensor(float("inf")), dist_reduce_fx="min")
        self.add_state("max_val", default=torch.tensor(float("-inf")), dist_reduce_fx="max")

    def _extrema(self, raw: Tensor) -> Tuple[Tensor, Tensor]:
        # a NaN raw value (a compute with no data) must not poison the extrema
        nan = torch.isnan(raw)
        return (torch.where(nan, self.min_val, torch.minimum(self.min_val, raw)),
                torch.where(nan, self.max_val, torch.maximum(self.max_val, raw)))

    def update(self, *args: Any, **kwargs: Any) -> None:
        self.base_metric.update(*args, **kwargs)

    def forward(self, *args: Any, **kwargs: Any) -> Optional[Dict[str, Tensor]]:
        """Accumulate and fold the batch value into the extrema (the base fused
        forward cannot run here: the wrapped metric is a child, not state)."""
        self._computed = None
        value = self.base_metric.forward(*args, **kwargs)
        if value is None:
            return None
        raw = torch.as_tensor(value).to(torch.float32)
        self.min_val, self.max_val = self._extrema(raw)
        self._forward_cache = {"raw": raw, "min": self.min_val, "max": self.max_val}
        return self._forward_cache

    def compute(self) -> Dict[str, Tensor]:
        raw = torch.as_tensor(self.base_metric.compute()).to(torch.float32)
        lo, hi = self._extrema(raw)
        return {"raw": raw, "min": lo, "max": hi}

    def _after_compute(self, result: Dict[str, Tensor]) -> None:
        # after the wrapped compute's sync restore: a write inside compute
        # itself would be discarded under a synced compute
        self.min_val = result["min"]
        self.max_val = result["max"]

    def reset(self) -> None:
        super().reset()
        self.base_metric.reset()
