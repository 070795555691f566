"""Contingency-matrix clustering metrics (stateful layer).

Counterpart of ``metrics_tpu/clustering/scores.py``. One shared base streams
the ``(num_clusters, num_classes)`` contingency count matrix as an int64
``"sum"`` state (a JAX int32 checkpoint loads into it); each subclass applies
its closed form at ``compute()``, in float64 (see
``metrics_tpu_torch/functional/clustering.py``). As in the JAX package, the
classes declare no compute-group key, so a ``MetricCollection`` updates and
syncs each member on its own.

Out-of-range labels (outside ``[0, num_clusters)`` / ``[0, num_classes)``)
are silently dropped; see ``_contingency``.
"""
from typing import Any, Callable, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.clustering import (
    _adjusted_mutual_info_compute,
    _adjusted_rand_compute,
    _contingency,
    _fowlkes_mallows_compute,
    _homogeneity_completeness,
    _mutual_info_compute,
    _normalized_mutual_info_compute,
    _rand_compute,
    _v_measure_compute,
)

_AVERAGE_METHODS = ("arithmetic", "geometric", "min", "max")


class _ContingencyMetric(Metric):
    """Shared base: stream the contingency matrix, compute a closed form."""

    def __init__(
        self,
        num_clusters: int,
        num_classes: int,
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
        if not isinstance(num_clusters, int) or num_clusters < 1:
            raise ValueError(f"`num_clusters` must be a positive int, got {num_clusters!r}")
        if not isinstance(num_classes, int) or num_classes < 1:
            raise ValueError(f"`num_classes` must be a positive int, got {num_classes!r}")
        self.num_clusters = num_clusters
        self.num_classes = num_classes
        self.add_state(
            "contingency",
            default=torch.zeros((num_clusters, num_classes), dtype=torch.int64),
            dist_reduce_fx="sum",
        )

    def update(self, preds: Tensor, target: Tensor) -> None:
        self.contingency = self.contingency + _contingency(preds, target, self.num_clusters, self.num_classes)

    def _score(self, cont: Tensor) -> Tensor:
        raise NotImplementedError

    def compute(self) -> Tensor:
        return self._score(self.contingency)


class RandScore(_ContingencyMetric):
    """Accumulated Rand index (``sklearn.metrics.rand_score``).

    Example:
        >>> import torch
        >>> metric = RandScore(num_clusters=2, num_classes=2, device="cpu")
        >>> float(metric(torch.tensor([0, 0, 1, 1]), torch.tensor([1, 1, 0, 0])))
        1.0
    """

    def _score(self, cont: Tensor) -> Tensor:
        return _rand_compute(cont)


class AdjustedRandScore(_ContingencyMetric):
    """Accumulated adjusted Rand index (``sklearn.metrics.adjusted_rand_score``).

    Example:
        >>> import torch
        >>> metric = AdjustedRandScore(num_clusters=2, num_classes=2, device="cpu")
        >>> float(metric(torch.tensor([0, 0, 1, 1]), torch.tensor([0, 0, 1, 1])))
        1.0
    """

    def _score(self, cont: Tensor) -> Tensor:
        return _adjusted_rand_compute(cont)


class MutualInfoScore(_ContingencyMetric):
    """Accumulated mutual information (``sklearn.metrics.mutual_info_score``).

    Example:
        >>> import torch
        >>> metric = MutualInfoScore(num_clusters=2, num_classes=2, device="cpu")
        >>> round(float(metric(torch.tensor([0, 0, 1, 1]), torch.tensor([0, 0, 1, 1]))), 4)
        0.6931
    """

    def _score(self, cont: Tensor) -> Tensor:
        return _mutual_info_compute(cont)


class NormalizedMutualInfoScore(_ContingencyMetric):
    """Accumulated NMI (``sklearn.metrics.normalized_mutual_info_score``).

    Example:
        >>> import torch
        >>> metric = NormalizedMutualInfoScore(num_clusters=2, num_classes=2, device="cpu")
        >>> float(metric(torch.tensor([0, 0, 1, 1]), torch.tensor([1, 1, 0, 0])))
        1.0
    """

    def __init__(self, num_clusters: int, num_classes: int, average_method: str = "arithmetic", **kwargs: Any):
        super().__init__(num_clusters, num_classes, **kwargs)
        if average_method not in _AVERAGE_METHODS:
            raise ValueError(
                f"average_method must be 'arithmetic', 'geometric', 'min' or 'max', got {average_method!r}"
            )
        self.average_method = average_method

    def _score(self, cont: Tensor) -> Tensor:
        return _normalized_mutual_info_compute(cont, self.average_method)


class AdjustedMutualInfoScore(NormalizedMutualInfoScore):
    """Accumulated AMI (``sklearn.metrics.adjusted_mutual_info_score``).

    The expected-MI chance term is a float64 sweep over each cell's feasible
    co-occurrence counts (``_expected_mutual_info``), with the epoch length
    read back once at ``compute()``. It agrees with sklearn at any epoch size
    (the JAX package's float32 sweep drifts past ~10^4 samples).

    Example:
        >>> import torch
        >>> metric = AdjustedMutualInfoScore(num_clusters=2, num_classes=2, device="cpu")
        >>> float(metric(torch.tensor([0, 0, 1, 1]), torch.tensor([1, 1, 0, 0])))
        1.0
    """

    def _score(self, cont: Tensor) -> Tensor:
        return _adjusted_mutual_info_compute(cont, int(cont.sum()), self.average_method)


class HomogeneityScore(_ContingencyMetric):
    """Accumulated homogeneity (``sklearn.metrics.homogeneity_score``).

    Example:
        >>> import torch
        >>> metric = HomogeneityScore(num_clusters=4, num_classes=2, device="cpu")
        >>> float(metric(torch.tensor([0, 1, 2, 3]), torch.tensor([0, 0, 1, 1])))
        1.0
    """

    def _score(self, cont: Tensor) -> Tensor:
        return _homogeneity_completeness(cont)[0]


class CompletenessScore(_ContingencyMetric):
    """Accumulated completeness (``sklearn.metrics.completeness_score``).

    Example:
        >>> import torch
        >>> metric = CompletenessScore(num_clusters=1, num_classes=2, device="cpu")
        >>> float(metric(torch.tensor([0, 0, 0, 0]), torch.tensor([0, 0, 1, 1])))
        1.0
    """

    def _score(self, cont: Tensor) -> Tensor:
        return _homogeneity_completeness(cont)[1]


class VMeasureScore(_ContingencyMetric):
    """Accumulated V-measure (``sklearn.metrics.v_measure_score``).

    Example:
        >>> import torch
        >>> metric = VMeasureScore(num_clusters=2, num_classes=2, device="cpu")
        >>> float(metric(torch.tensor([0, 0, 1, 1]), torch.tensor([0, 0, 1, 1])))
        1.0
    """

    def __init__(self, num_clusters: int, num_classes: int, beta: float = 1.0, **kwargs: Any):
        super().__init__(num_clusters, num_classes, **kwargs)
        if beta < 0:
            raise ValueError(f"`beta` must be non-negative, got {beta!r}")
        self.beta = beta

    def _score(self, cont: Tensor) -> Tensor:
        return _v_measure_compute(cont, self.beta)


class FowlkesMallowsScore(_ContingencyMetric):
    """Accumulated Fowlkes-Mallows index (``sklearn.metrics.fowlkes_mallows_score``).

    Example:
        >>> import torch
        >>> metric = FowlkesMallowsScore(num_clusters=2, num_classes=2, device="cpu")
        >>> round(float(metric(torch.tensor([0, 0, 1, 1]), torch.tensor([0, 0, 1, 1]))), 4)
        1.0
    """

    def _score(self, cont: Tensor) -> Tensor:
        return _fowlkes_mallows_compute(cont)
