"""MetricTracker: one copy of a metric per epoch (increment), and the best of them.

Counterpart of ``metrics_tpu/wrappers/tracker.py``.
"""
from copy import deepcopy
from typing import Any, Tuple, Union

import numpy as np
import torch
from torch import Tensor, nn

from metrics_tpu_torch.core.metric import Metric

__all__ = ["MetricTracker"]


class MetricTracker(Metric):
    r"""Track a metric (or collection) over epochs.

    Call ``increment()`` at each epoch boundary; update / forward go to the
    newest copy. ``compute_all()`` stacks every increment's value and
    ``best_metric()`` returns the best (optionally with its index).

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Accuracy
        >>> tracker = MetricTracker(Accuracy(device="cpu"))
        >>> for epoch in range(2):
        ...     tracker.increment()
        ...     _ = tracker(torch.tensor([1, 1, 0, 0]), torch.tensor([1, epoch, 0, 0]))
        >>> float(tracker.best_metric())
        1.0
    """

    def __init__(self, base_metric: Metric, maximize: bool = True):
        if not isinstance(base_metric, Metric):
            raise ValueError(f"`base_metric` must be a Metric, got {type(base_metric).__name__}")
        super().__init__(compute_on_step=base_metric.compute_on_step, device=base_metric.device)
        self._base = base_metric
        self.maximize = maximize
        self._increments = nn.ModuleList()

    @property
    def n_steps(self) -> int:
        return len(self._increments)

    def _current(self) -> Metric:
        if not len(self._increments):
            raise RuntimeError("call `tracker.increment()` before updating the tracker")
        return self._increments[-1]

    def increment(self) -> None:
        """Start tracking a fresh copy of the base metric."""
        self._computed = None
        fresh = deepcopy(self._base)
        fresh.reset()
        self._increments.append(fresh)

    def update(self, *args: Any, **kwargs: Any) -> None:
        self._current().update(*args, **kwargs)

    def forward(self, *args: Any, **kwargs: Any) -> Any:
        self._computed = None  # bypasses the wrapped update: clear the cache here
        return self._current().forward(*args, **kwargs)

    def compute(self) -> Any:
        return self._current().compute()

    def compute_all(self) -> Tensor:
        """Values of every increment, stacked along a leading step axis (float32)."""
        return torch.stack([torch.as_tensor(m.compute()).to(torch.float32) for m in self._increments])

    def best_metric(self, return_step: bool = False) -> Union[Tensor, Tuple[Tensor, int]]:
        """The best scalar value across increments (and its step index)."""
        values = self.compute_all().cpu().numpy()
        if values.ndim != 1:
            raise ValueError(
                "best_metric is defined for scalar metrics; use compute_all() for"
                f" higher-rank values (got shape {values.shape})"
            )
        step = int(np.argmax(values) if self.maximize else np.argmin(values))
        best = torch.as_tensor(values[step])
        return (best, step) if return_step else best

    def reset(self) -> None:
        """Reset the current increment (keeps the history)."""
        self._computed = None
        if len(self._increments):
            self._current().reset()

    def reset_all(self) -> None:
        """Drop all history."""
        self._computed = None
        self._increments = nn.ModuleList()
