"""Per-row cosine similarity. Counterpart of ``metrics_tpu/functional/regression/cosine_similarity.py``."""
import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape


def _cosine_similarity_rows(preds: Tensor, target: Tensor) -> Tensor:
    _check_same_shape(preds, target)
    if preds.ndim != 2:
        raise ValueError("Expected `preds` and `target` to be 2D arrays of shape (N, D)")
    x, y = preds.to(torch.float32), target.to(torch.float32)
    dot = torch.sum(x * y, dim=1)
    norm = torch.linalg.vector_norm(x, dim=1) * torch.linalg.vector_norm(y, dim=1)
    zero = norm == 0
    return torch.where(zero, torch.zeros_like(dot), dot / torch.where(zero, torch.ones_like(norm), norm))


def cosine_similarity(preds: Tensor, target: Tensor, reduction: str = "mean") -> Tensor:
    """Cosine similarity of each ``(N, D)`` row pair, reduced over rows by
    ``'mean'``, ``'sum'`` or ``'none'``.

    Example:
        >>> import torch
        >>> preds = torch.tensor([[1.0, 0.0], [1.0, 1.0]])
        >>> target = torch.tensor([[1.0, 0.0], [0.0, 1.0]])
        >>> round(float(cosine_similarity(preds, target)), 4)
        0.8536
    """
    if reduction not in ("mean", "sum", "none", None):
        raise ValueError(f"Expected reduction to be one of 'mean', 'sum', 'none', got {reduction}")
    sim = _cosine_similarity_rows(preds, target)
    if reduction == "mean":
        return torch.mean(sim)
    if reduction == "sum":
        return torch.sum(sim)
    return sim
