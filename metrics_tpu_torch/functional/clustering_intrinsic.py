"""Intrinsic (no ground-truth labels) clustering quality scores.

Counterpart of ``metrics_tpu/functional/clustering_intrinsic.py``:

* ``calinski_harabasz_score`` is a closed form of per-cluster moments; the
  stateful metric streams one ``(k, 2 + d)`` ``[n, M2, mean]`` block whose
  rank reduction is a per-cluster Chan parallel merge (associative, so
  batches, ranks and checkpoint shards combine the same way);
* ``davies_bouldin_score`` needs the mean Euclidean (not squared) distance of
  each point to its centroid, a two-pass quantity, so the stateful metric
  keeps the samples and computes at the epoch.

The per-cluster sums are one-hot products, as in the JAX package, which pins
them to ``precision="highest"``: here they run in full float32 inside
:func:`~metrics_tpu_torch.utils.data.full_fp32_matmul`, so the caller's TF32
setting does not change them. A cuBLAS product is deterministic from run to
run, where a float atomic scatter is not.

Both match sklearn on populated clusters; empty clusters are excluded from
the cluster counts, matching sklearn's unique-label semantics.
"""
from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.parallel.sync import associative
from metrics_tpu_torch.utils.data import full_fp32_matmul


def _check_data_labels(data: Tensor, labels: Tensor) -> None:
    if data.ndim != 2 or labels.ndim != 1 or data.shape[0] != labels.shape[0]:
        raise ValueError(
            f"Expected data (N, d) and labels (N,), got {tuple(data.shape)} and {tuple(labels.shape)}"
        )


def _onehot(labels: Tensor, num_clusters: int) -> Tensor:
    """``(N, k)`` float32 one-hot; an out-of-range label gives a zero row, as ``jax.nn.one_hot`` does."""
    classes = torch.arange(num_clusters, device=labels.device)
    return (labels.to(torch.int64)[:, None] == classes[None, :]).to(torch.float32)


def _centroids(data: Tensor, onehot: Tensor) -> Tuple[Tensor, Tensor]:
    """(counts (k,), per-cluster means (k, d)) in float32."""
    counts = onehot.sum(0)
    with full_fp32_matmul():
        sums = onehot.T @ data
    return counts, sums / torch.clamp(counts, min=1.0)[:, None]


def _gather_rows(table: Tensor, labels: Tensor) -> Tensor:
    """``table[labels]``, an out-of-range label reading row 0 as ``jnp`` indexing clamps."""
    return table[torch.clamp(labels.to(torch.int64), 0, table.shape[0] - 1)]


def _cluster_moments_batch(data: Tensor, labels: Tensor, num_clusters: int) -> Tensor:
    """Exact per-cluster ``[n, M2, mean...]`` moments of one batch.

    Shape ``(num_clusters, 2 + d)``: column 0 is the count, column 1 the
    within-cluster sum of squared residuals (M2, summed over features),
    columns 2: the cluster mean. Two-pass within the batch, so there is no
    large-offset cancellation; batches combine with :func:`cluster_chan_merge`.
    """
    _check_data_labels(data, labels)
    data = data.to(torch.float32)
    onehot = _onehot(labels, num_clusters)
    counts, mean = _centroids(data, onehot)
    resid = data - _gather_rows(mean, labels)
    with full_fp32_matmul():
        m2 = onehot.T @ (resid * resid).sum(1)
    return torch.cat([counts[:, None], m2[:, None], mean], dim=1)


def cluster_chan_merge(a: Tensor, b: Tensor) -> Tensor:
    """Chan parallel merge of two ``(k, 2 + d)`` per-cluster moment blocks.

    Exact when either side of a cluster is empty (n = 0 reduces to the other side).
    """
    na, nb = a[:, 0], b[:, 0]
    n = na + nb
    nsafe = torch.where(n == 0, torch.ones_like(n), n)
    delta = b[:, 2:] - a[:, 2:]
    mean = a[:, 2:] + delta * (nb / nsafe)[:, None]
    m2 = a[:, 1] + b[:, 1] + (delta * delta).sum(1) * na * nb / nsafe
    return torch.cat([n[:, None], m2[:, None], mean], dim=1)


@associative
def cluster_chan_fold(stacked: Tensor) -> Tensor:
    """Fold a ``(world, k, 2 + d)`` stack of moment blocks in rank order (associative)."""
    out = stacked[0]
    for i in range(1, stacked.shape[0]):
        out = cluster_chan_merge(out, stacked[i])
    return out


def _ch_from_cluster_moments(moments: Tensor) -> Tensor:
    counts, m2, means = moments[:, 0], moments[:, 1], moments[:, 2:]
    n = counts.sum()
    populated = counts > 0
    k = populated.sum().to(torch.float32)
    zero = torch.zeros_like(m2)
    w = torch.sum(torch.where(populated, m2, zero))
    mu = (counts[:, None] * means).sum(0) / torch.clamp(n, min=1.0)
    b = torch.sum(torch.where(populated, counts * ((means - mu) ** 2).sum(1), zero))
    denom = w * torch.clamp(k - 1.0, min=1e-30)
    ok = denom > 0
    value = b * torch.clamp(n - k, min=0.0) / torch.where(ok, denom, torch.ones_like(denom))
    return torch.where((k > 1) & (w > 0), value, torch.ones_like(value))


# bytes of one (rows, k, d) block of centroid differences
_SEPARATION_CHUNK_BYTES = 1 << 29


def _centroid_distances(centroids: Tensor) -> Tensor:
    """``(k, k)`` Euclidean distances between centroids as the JAX package takes
    them (the root of the summed squared differences), over row blocks of the
    ``(k, k, d)`` differences so that no block exceeds ``_SEPARATION_CHUNK_BYTES``."""
    k, d = centroids.shape
    rows = max(1, _SEPARATION_CHUNK_BYTES // max(1, 4 * k * d))
    blocks = []
    for r0 in range(0, k, rows):
        diff = centroids[r0:r0 + rows, None, :] - centroids[None, :, :]
        blocks.append(torch.sqrt(torch.clamp((diff * diff).sum(-1), min=0.0)))
    return torch.cat(blocks) if blocks else centroids.new_zeros((0, 0))


def calinski_harabasz_score(data: Tensor, labels: Tensor, num_clusters: int) -> Tensor:
    """Variance-ratio criterion (``sklearn.metrics.calinski_harabasz_score``).

    Example:
        >>> import torch
        >>> data = torch.tensor([[0.0, 0.0], [0.1, 0.0], [5.0, 5.0], [5.1, 5.0]])
        >>> labels = torch.tensor([0, 0, 1, 1])
        >>> round(float(calinski_harabasz_score(data, labels, num_clusters=2)), 1)
        10000.0
    """
    # one batch is one exact two-pass moment block; the closed form is the one
    # the streaming class applies to its Chan-merged state
    return _ch_from_cluster_moments(_cluster_moments_batch(data, labels, num_clusters))


def davies_bouldin_score(data: Tensor, labels: Tensor, num_clusters: int) -> Tensor:
    """Average worst-case cluster similarity
    (``sklearn.metrics.davies_bouldin_score``; lower is better).

    Example:
        >>> import torch
        >>> data = torch.tensor([[0.0, 0.0], [0.1, 0.0], [5.0, 5.0], [5.1, 5.0]])
        >>> labels = torch.tensor([0, 0, 1, 1])
        >>> round(float(davies_bouldin_score(data, labels, num_clusters=2)), 4)
        0.0141
    """
    _check_data_labels(data, labels)
    data = data.to(torch.float32)
    onehot = _onehot(labels, num_clusters)
    counts, centroids = _centroids(data, onehot)
    # mean Euclidean distance of each point to ITS centroid (two-pass)
    dists = torch.linalg.vector_norm(data - _gather_rows(centroids, labels), dim=1)
    with full_fp32_matmul():
        s = (onehot.T @ dists) / torch.clamp(counts, min=1.0)  # (k,)
    m = _centroid_distances(centroids)
    populated = counts > 0
    eye = torch.eye(num_clusters, dtype=torch.bool, device=data.device)
    pair_ok = populated[:, None] & populated[None, :] & ~eye & (m > 0)
    r = torch.where(pair_ok, (s[:, None] + s[None, :]) / torch.where(m > 0, m, torch.ones_like(m)), torch.zeros_like(m))
    per_cluster = r.max(dim=1).values
    n_pop = populated.sum()
    k = torch.clamp(n_pop.to(torch.float32), min=1.0)
    value = torch.sum(torch.where(populated, per_cluster, torch.zeros_like(per_cluster))) / k
    return torch.where(n_pop > 1, value, torch.zeros_like(value))
