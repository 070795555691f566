"""KL divergence between pairs of distributions. Counterpart of
``metrics_tpu/functional/regression/kl_divergence.py``."""
from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape

_EPS = 1e-10


def _kld_update(p: Tensor, q: Tensor, log_prob: bool) -> Tuple[Tensor, int]:
    _check_same_shape(p, q)
    if p.ndim != 2:
        raise ValueError("Expected both `p` and `q` distributions to be 2D of shape (N, d)")
    p, q = p.to(torch.float32), q.to(torch.float32)
    if log_prob:
        measures = torch.sum(torch.exp(p) * (p - q), dim=-1)
    else:
        p = p / torch.clamp_min(torch.sum(p, dim=-1, keepdim=True), _EPS)
        q = q / torch.clamp_min(torch.sum(q, dim=-1, keepdim=True), _EPS)
        q = torch.clamp_min(q, _EPS)
        measures = torch.sum(p * torch.log(torch.clamp_min(p, _EPS) / q), dim=-1)
    return torch.sum(measures), p.shape[0]


def kl_divergence(p: Tensor, q: Tensor, log_prob: bool = False, reduction: str = "mean") -> Tensor:
    """KL(p || q) per row pair of ``(N, d)`` distributions (rows renormalized
    unless ``log_prob``), reduced over rows by ``'mean'`` or ``'sum'``.

    Example:
        >>> import torch
        >>> p = torch.tensor([[0.36, 0.48, 0.16]])
        >>> q = torch.tensor([[1/3, 1/3, 1/3]])
        >>> round(float(kl_divergence(p, q)), 4)
        0.0853
    """
    if reduction not in ("mean", "sum"):
        raise ValueError(f"Expected reduction to be 'mean' or 'sum', got {reduction}")
    total, n = _kld_update(p, q, log_prob)
    return total / max(n, 1) if reduction == "mean" else total
