"""Nominal association metrics on the streamed contingency matrix.
Counterpart of ``metrics_tpu/nominal/association.py``."""
from typing import Any, Callable, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.clustering import _contingency
from metrics_tpu_torch.functional.nominal import (
    _cramers_v_compute,
    _pearson_cc_compute,
    _theils_u_compute,
    _tschuprows_t_compute,
)


class _AssociationMetric(Metric):
    """Shared base: stream the (preds-classes, target-classes) int64 contingency."""

    def __init__(
        self,
        num_classes_preds: int,
        num_classes_target: Optional[int] = None,
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
        if num_classes_target is None:
            num_classes_target = num_classes_preds
        for name, v in (("num_classes_preds", num_classes_preds), ("num_classes_target", num_classes_target)):
            if not isinstance(v, int) or v < 1:
                raise ValueError(f"`{name}` must be a positive int, got {v!r}")
        self.num_classes_preds = num_classes_preds
        self.num_classes_target = num_classes_target
        self.add_state(
            "contingency",
            default=torch.zeros((num_classes_preds, num_classes_target), dtype=torch.int64),
            dist_reduce_fx="sum",
        )

    def update(self, preds: Tensor, target: Tensor) -> None:
        self.contingency = self.contingency + _contingency(
            preds, target, self.num_classes_preds, self.num_classes_target
        )

    def _score(self, cont: Tensor) -> Tensor:
        raise NotImplementedError

    def compute(self) -> Tensor:
        return self._score(self.contingency)


class CramersV(_AssociationMetric):
    """Accumulated Cramer's V (``scipy.stats.contingency.association``,
    ``method='cramer'``; optional Bergsma bias correction).

    Example:
        >>> import torch
        >>> metric = CramersV(num_classes_preds=3, device="cpu")
        >>> round(float(metric(torch.tensor([0, 0, 1, 1, 2, 2]), torch.tensor([0, 0, 1, 1, 2, 2]))), 4)
        1.0
    """

    def __init__(self, num_classes_preds: int, num_classes_target: Optional[int] = None,
                 bias_correction: bool = False, **kwargs: Any):
        super().__init__(num_classes_preds, num_classes_target, **kwargs)
        self.bias_correction = bias_correction

    def _score(self, cont: Tensor) -> Tensor:
        return _cramers_v_compute(cont, self.bias_correction)


class PearsonsContingencyCoefficient(_AssociationMetric):
    """Accumulated Pearson's contingency coefficient
    (``scipy.stats.contingency.association``, ``method='pearson'``).

    Example:
        >>> import torch
        >>> metric = PearsonsContingencyCoefficient(num_classes_preds=2, device="cpu")
        >>> round(float(metric(torch.tensor([0, 0, 1, 1]), torch.tensor([0, 0, 1, 1]))), 4)
        0.7071
    """

    def _score(self, cont: Tensor) -> Tensor:
        return _pearson_cc_compute(cont)


class TschuprowsT(_AssociationMetric):
    """Accumulated Tschuprow's T (``scipy.stats.contingency.association``, ``method='tschuprow'``).

    Example:
        >>> import torch
        >>> metric = TschuprowsT(num_classes_preds=3, device="cpu")
        >>> round(float(metric(torch.tensor([0, 0, 1, 1, 2, 2]), torch.tensor([0, 0, 1, 1, 2, 2]))), 4)
        1.0
    """

    def _score(self, cont: Tensor) -> Tensor:
        return _tschuprows_t_compute(cont)


class TheilsU(_AssociationMetric):
    """Accumulated Theil's U, asymmetric: how much knowing ``preds`` reduces
    the entropy of ``target``.

    Example:
        >>> import torch
        >>> metric = TheilsU(num_classes_preds=2, device="cpu")
        >>> round(float(metric(torch.tensor([0, 0, 1, 1]), torch.tensor([0, 0, 1, 1]))), 4)
        1.0
    """

    def _score(self, cont: Tensor) -> Tensor:
        return _theils_u_compute(cont)
