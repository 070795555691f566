"""Stateful intrinsic clustering scores. Counterpart of ``metrics_tpu/clustering/intrinsic.py``.

``CalinskiHarabaszScore`` streams one float32 per-cluster ``[n, M2, mean]``
moment block whose reduction is a per-cluster Chan parallel merge, marked
``associative``: the one-delta ``forward`` folds a batch into it, and a rank
sync gathers the ``(world, k, 2 + d)`` stack and folds it in rank order.
``DaviesBouldinScore`` needs mean Euclidean distances to the epoch's
centroids, so it keeps the samples (list states, or PaddedBuffers with
``capacity=``), gathered across ranks at ``compute()``.
"""
from typing import Any, Callable, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.clustering_intrinsic import (
    _ch_from_cluster_moments,
    _check_data_labels,
    _cluster_moments_batch,
    cluster_chan_fold,
    cluster_chan_merge,
    davies_bouldin_score,
)
from metrics_tpu_torch.parallel.buffer import as_values


class CalinskiHarabaszScore(Metric):
    """Streaming variance-ratio criterion (``sklearn.metrics.calinski_harabasz_score``).

    Example:
        >>> import torch
        >>> metric = CalinskiHarabaszScore(num_clusters=2, num_features=2, device="cpu")
        >>> data = torch.tensor([[0.0, 0.0], [0.1, 0.0], [5.0, 5.0], [5.1, 5.0]])
        >>> labels = torch.tensor([0, 0, 1, 1])
        >>> round(float(metric(data, labels)), 1)
        10000.0
    """

    def __init__(
        self,
        num_clusters: int,
        num_features: int,
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
        if not isinstance(num_features, int) or num_features < 1:
            raise ValueError(f"`num_features` must be a positive int, got {num_features!r}")
        self.num_clusters = num_clusters
        self.num_features = num_features
        self.add_state(
            "moments",
            default=torch.zeros((num_clusters, 2 + num_features), dtype=torch.float32),
            dist_reduce_fx=cluster_chan_fold,
        )

    def update(self, data: Tensor, labels: Tensor) -> None:
        if data.ndim == 2 and data.shape[1] != self.num_features:
            raise ValueError(
                f"data has {data.shape[1]} features, metric was built with num_features={self.num_features}"
            )
        self.moments = cluster_chan_merge(self.moments, _cluster_moments_batch(data, labels, self.num_clusters))

    def compute(self) -> Tensor:
        return _ch_from_cluster_moments(self.moments)


class DaviesBouldinScore(Metric):
    """Accumulated Davies-Bouldin index (``sklearn.metrics.davies_bouldin_score``; lower is better).

    Example:
        >>> import torch
        >>> metric = DaviesBouldinScore(num_clusters=2, device="cpu")
        >>> data = torch.tensor([[0.0, 0.0], [0.1, 0.0], [5.0, 5.0], [5.1, 5.0]])
        >>> labels = torch.tensor([0, 0, 1, 1])
        >>> round(float(metric(data, labels)), 4)
        0.0141
    """

    def __init__(
        self,
        num_clusters: int,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
        capacity: Optional[int] = None,
    ):
        super().__init__(
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
            capacity=capacity,
        )
        if not isinstance(num_clusters, int) or num_clusters < 1:
            raise ValueError(f"`num_clusters` must be a positive int, got {num_clusters!r}")
        self.num_clusters = num_clusters
        self.add_state("data_all", default=[], dist_reduce_fx=None)
        self.add_state("labels_all", default=[], dist_reduce_fx=None, item_shape=(), item_dtype=torch.int32)

    def update(self, data: Tensor, labels: Tensor) -> None:
        _check_data_labels(data, labels)
        self._append("data_all", data.to(torch.float32))
        self._append("labels_all", labels.to(torch.int32))

    def compute(self) -> Tensor:
        if isinstance(self.data_all, list) and not self.data_all:
            return torch.tensor(float("nan"), device=self.device)
        data = as_values(self.data_all)
        if data.shape[0] == 0:
            return torch.tensor(float("nan"), device=self.device)
        return davies_bouldin_score(data, as_values(self.labels_all), self.num_clusters)
