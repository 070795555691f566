"""Pairwise similarity / distance matrices. Counterpart of ``metrics_tpu/functional/pairwise.py``.

The JAX package pins its products to ``precision="highest"``; here they run
in full float32 inside :func:`~metrics_tpu_torch.utils.data.full_fp32_matmul`,
so the caller's TF32 setting does not change them. The Manhattan distance is
``torch.cdist(p=1)``, which never materialises the ``(N, M, d)`` differences
the JAX package's broadcast names (XLA fuses it; an eager broadcast would hold
275 GB at 8,192 x 4,096 x 2,048).

Semantics match ``sklearn.metrics.pairwise``: ``y=None`` compares ``x`` with
itself, ``zero_diagonal`` (default: only when ``y`` is ``None``) zeroes the
self-comparisons, and ``reduction`` in ``{None, 'none', 'mean', 'sum'}``
optionally collapses each row.
"""
from typing import Optional, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.data import full_fp32_matmul


def _prepare(x: Tensor, y: Optional[Tensor], zero_diagonal: Optional[bool]) -> Tuple[Tensor, Tensor, bool]:
    if x.ndim != 2:
        raise ValueError(f"Expected x to be 2-D (N, d), got {tuple(x.shape)}")
    if y is not None and (y.ndim != 2 or y.shape[1] != x.shape[1]):
        raise ValueError(f"Expected y of shape (M, {x.shape[1]}), got {tuple(y.shape)}")
    if zero_diagonal is None:
        zero_diagonal = y is None
    y = x if y is None else y
    return x.to(torch.float32), y.to(torch.float32), zero_diagonal


def _finalize(mat: Tensor, zero_diagonal: bool, reduction: Optional[str]) -> Tensor:
    if zero_diagonal:
        mat.diagonal().zero_()  # mat is this call's own result
    if reduction == "mean":
        return mat.mean(dim=-1)
    if reduction == "sum":
        return mat.sum(dim=-1)
    if reduction in (None, "none"):
        return mat
    raise ValueError(f"reduction must be None, 'none', 'mean' or 'sum', got {reduction!r}")


def _matmul_t(x: Tensor, y: Tensor) -> Tensor:
    """``x @ y.T`` in full float32."""
    with full_fp32_matmul():
        return x @ y.T


def pairwise_cosine_similarity(
    x: Tensor, y: Optional[Tensor] = None, reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> Tensor:
    """``sim[i, j] = <x_i, y_j> / (|x_i| |y_j|)`` (``sklearn.metrics.pairwise.cosine_similarity``).

    Example:
        >>> import torch
        >>> x = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
        >>> y = torch.tensor([[1.0, 1.0]])
        >>> pairwise_cosine_similarity(x, y).round(decimals=4)
        tensor([[0.7071],
                [0.7071]])
    """
    x, y, zero_diagonal = _prepare(x, y, zero_diagonal)
    xn = x / torch.clamp(torch.linalg.vector_norm(x, dim=1, keepdim=True), min=1e-30)
    yn = y / torch.clamp(torch.linalg.vector_norm(y, dim=1, keepdim=True), min=1e-30)
    return _finalize(_matmul_t(xn, yn), zero_diagonal, reduction)


def pairwise_euclidean_distance(
    x: Tensor, y: Optional[Tensor] = None, reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> Tensor:
    """``dist[i, j] = |x_i - y_j|_2`` (``sklearn.metrics.pairwise.euclidean_distances``).

    Example:
        >>> import torch
        >>> x = torch.tensor([[0.0, 0.0], [3.0, 4.0]])
        >>> pairwise_euclidean_distance(x)
        tensor([[0., 5.],
                [5., 0.]])
    """
    x, y, zero_diagonal = _prepare(x, y, zero_diagonal)
    # |x-y|^2 = |x|^2 - 2<x,y> + |y|^2; clamp the cancellation
    sq = (x * x).sum(1)[:, None] - 2.0 * _matmul_t(x, y) + (y * y).sum(1)[None, :]
    return _finalize(torch.sqrt(torch.clamp(sq, min=0.0)), zero_diagonal, reduction)


def pairwise_manhattan_distance(
    x: Tensor, y: Optional[Tensor] = None, reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> Tensor:
    """``dist[i, j] = |x_i - y_j|_1`` (``sklearn.metrics.pairwise.manhattan_distances``).

    Example:
        >>> import torch
        >>> x = torch.tensor([[0.0, 0.0], [1.0, 2.0]])
        >>> pairwise_manhattan_distance(x)
        tensor([[0., 3.],
                [3., 0.]])
    """
    x, y, zero_diagonal = _prepare(x, y, zero_diagonal)
    return _finalize(torch.cdist(x, y, p=1.0), zero_diagonal, reduction)


def pairwise_linear_similarity(
    x: Tensor, y: Optional[Tensor] = None, reduction: Optional[str] = None,
    zero_diagonal: Optional[bool] = None,
) -> Tensor:
    """``sim[i, j] = <x_i, y_j>`` (the linear kernel, ``sklearn.metrics.pairwise.linear_kernel``).

    Example:
        >>> import torch
        >>> x = torch.tensor([[1.0, 2.0], [3.0, 4.0]])
        >>> pairwise_linear_similarity(x, zero_diagonal=False)
        tensor([[ 5., 11.],
                [11., 25.]])
    """
    x, y, zero_diagonal = _prepare(x, y, zero_diagonal)
    return _finalize(_matmul_t(x, y), zero_diagonal, reduction)
