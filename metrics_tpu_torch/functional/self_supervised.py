"""Embedding similarity. Counterpart of ``metrics_tpu/functional/self_supervised.py``.

The square similarity product runs in full float32 (the JAX package's
``Precision.HIGHEST``) inside :func:`~metrics_tpu_torch.utils.data.full_fp32_matmul`.
"""
import torch
from torch import Tensor

from metrics_tpu_torch.utils.data import full_fp32_matmul


def embedding_similarity(
    batch: Tensor, similarity: str = "cosine", reduction: str = "none", zero_diagonal: bool = True
) -> Tensor:
    """Pairwise representation similarity for a ``(batch, dim)`` tensor.

    Example:
        >>> import torch
        >>> embeddings = torch.tensor([[1., 2., 3., 4.], [1., 2., 3., 4.], [4., 5., 6., 7.]])
        >>> embedding_similarity(embeddings).round(decimals=4)
        tensor([[0.0000, 1.0000, 0.9759],
                [1.0000, 0.0000, 0.9759],
                [0.9759, 0.9759, 0.0000]])
    """
    if similarity == "cosine":
        norm = torch.linalg.vector_norm(batch, ord=2, dim=1)
        batch = batch / norm[:, None]

    with full_fp32_matmul():
        sqr_mtx = batch @ batch.T

    if zero_diagonal:
        sqr_mtx = sqr_mtx * (1 - torch.eye(sqr_mtx.shape[0], dtype=sqr_mtx.dtype, device=sqr_mtx.device))

    if reduction == "mean":
        sqr_mtx = torch.mean(sqr_mtx, dim=-1)
    if reduction == "sum":
        sqr_mtx = torch.sum(sqr_mtx, dim=-1)

    return sqr_mtx
