"""MultioutputWrapper: a base metric applied to each output column on its own.

Counterpart of ``metrics_tpu/wrappers/multioutput.py``.
"""
from typing import Any, Optional, Tuple

import torch
from torch import Tensor, nn

from metrics_tpu_torch.core.metric import Metric

__all__ = ["MultioutputWrapper"]


class MultioutputWrapper(Metric):
    r"""Apply a base metric independently to each output column.

    Wraps ``num_outputs`` clones of ``base_metric``; every update / forward
    takes column ``i`` of the (..., ``num_outputs``) preds and target into
    clone ``i``, and ``compute()`` stacks the clones' results into a
    ``(num_outputs,)`` vector. The clones are ordinary child metrics.

    Args:
        base_metric: the metric to replicate per output column.
        num_outputs: number of output columns.
        output_dim: axis holding the outputs (default ``-1``).
        remove_nans: drop the rows where preds or target is NaN in a column
            before updating that column's clone.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import MeanSquaredError
        >>> m = MultioutputWrapper(MeanSquaredError(device="cpu"), num_outputs=2)
        >>> preds = torch.tensor([[1.0, 10.0], [2.0, 20.0]])
        >>> target = torch.tensor([[1.0, 14.0], [3.0, 22.0]])
        >>> [round(float(v), 2) for v in m(preds, target)]
        [0.5, 10.0]
    """

    def __init__(self, base_metric: Metric, num_outputs: int, output_dim: int = -1, remove_nans: bool = True):
        if not isinstance(base_metric, Metric):
            raise ValueError(f"`base_metric` must be a Metric, got {type(base_metric).__name__}")
        if not isinstance(num_outputs, int) or num_outputs < 1:
            raise ValueError(f"`num_outputs` must be a positive int, got {num_outputs!r}")
        super().__init__(compute_on_step=base_metric.compute_on_step, device=base_metric.device)
        self.metrics = nn.ModuleList([base_metric.clone() for _ in range(num_outputs)])
        self.num_outputs = num_outputs
        self.output_dim = output_dim
        self.remove_nans = remove_nans

    def _any_nans(self, preds: Tensor, target: Tensor) -> bool:
        """At most one read back to the host an update, none for int inputs:
        the per-column compression is data-dependent, so one NaN probe over
        the whole arrays decides whether any column needs it."""
        if not self.remove_nans:
            return False
        checks = [x for x in (preds, target) if x.is_floating_point()]
        if not checks:
            return False
        return bool(torch.stack([torch.isnan(x).any() for x in checks]).any())

    def _pair(self, preds: Tensor, target: Tensor, i: int, filter_nans: bool) -> Tuple[Tensor, Tensor]:
        p = torch.select(preds, self.output_dim, i)
        t = torch.select(target, self.output_dim, i)
        if filter_nans:
            keep = ~(torch.isnan(p.to(torch.float32)) | torch.isnan(t.to(torch.float32)))
            p, t = p[keep], t[keep]
        return p, t

    def update(self, preds: Tensor, target: Tensor) -> None:
        filter_nans = self._any_nans(preds, target)
        for i, m in enumerate(self.metrics):
            m.update(*self._pair(preds, target, i, filter_nans))

    def forward(self, preds: Tensor, target: Tensor) -> Optional[Tensor]:
        filter_nans = self._any_nans(preds, target)
        values = [m.forward(*self._pair(preds, target, i, filter_nans)) for i, m in enumerate(self.metrics)]
        self._computed = None
        if any(v is None for v in values):
            return None
        return torch.stack(values)

    def compute(self) -> Tensor:
        return torch.stack([m.compute() for m in self.metrics])

    def reset(self) -> None:
        super().reset()
        for m in self.metrics:
            m.reset()

    def persistent(self, mode: bool = False) -> None:
        for m in self.metrics:
            m.persistent(mode)
