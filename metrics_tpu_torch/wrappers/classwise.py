"""ClasswiseWrapper: a per-class metric vector as a labelled dict.

Counterpart of ``metrics_tpu/wrappers/classwise.py``.
"""
from typing import Any, Dict, List, Optional

from torch import Tensor

from metrics_tpu_torch.core.metric import Metric

__all__ = ["ClasswiseWrapper"]


class ClasswiseWrapper(Metric):
    r"""Unpack a per-class metric vector into a flat, labelled dict.

    Wraps a metric whose ``compute()`` returns a ``(C,)`` vector (e.g.
    ``Precision(average=None)``) and returns ``{f"{prefix}{label}": value}``.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch import Precision
        >>> m = ClasswiseWrapper(Precision(num_classes=3, average=None, device="cpu"), labels=["cat", "dog", "fox"])
        >>> out = m(torch.tensor([0, 1, 2, 1]), torch.tensor([0, 1, 1, 1]))
        >>> sorted(out)
        ['precision_cat', 'precision_dog', 'precision_fox']
    """

    def __init__(self, base_metric: Metric, labels: Optional[List[str]] = None, prefix: Optional[str] = None):
        if not isinstance(base_metric, Metric):
            raise ValueError(f"`base_metric` must be a Metric, got {type(base_metric).__name__}")
        super().__init__(compute_on_step=base_metric.compute_on_step, device=base_metric.device)
        if labels is not None and not (isinstance(labels, list) and all(isinstance(x, str) for x in labels)):
            raise ValueError(f"`labels` must be a list of strings or None, got {labels!r}")
        self.base_metric = base_metric
        self.labels = labels
        self._prefix = prefix if prefix is not None else type(base_metric).__name__.lower() + "_"

    def _to_dict(self, values: Tensor) -> Dict[str, Tensor]:
        if values.ndim != 1:
            raise ValueError(f"the wrapped metric must compute a 1-D per-class vector, got shape {tuple(values.shape)}")
        labels = self.labels if self.labels is not None else [str(i) for i in range(values.shape[0])]
        if len(labels) != values.shape[0]:
            raise ValueError(f"{len(labels)} labels for {values.shape[0]} classes")
        return {f"{self._prefix}{lab}": values[i] for i, lab in enumerate(labels)}

    def update(self, *args: Any, **kwargs: Any) -> None:
        self.base_metric.update(*args, **kwargs)

    def forward(self, *args: Any, **kwargs: Any) -> Optional[Dict[str, Tensor]]:
        value = self.base_metric.forward(*args, **kwargs)
        self._computed = None
        if value is None:
            return None
        return self._to_dict(value)

    def compute(self) -> Dict[str, Tensor]:
        return self._to_dict(self.base_metric.compute())

    def reset(self) -> None:
        super().reset()
        self.base_metric.reset()
