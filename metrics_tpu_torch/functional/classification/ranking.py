"""Multilabel ranking metrics: coverage error, LRAP, label ranking loss.

Counterpart of ``metrics_tpu/functional/classification/ranking.py``, with
sklearn's semantics: ties count pessimistically (``>=`` throughout, so a
tied (true, false) pair is a violation), and degenerate rows score as sklearn
scores them (no true label: coverage 0, LRAP 1, loss 0; all true: LRAP 1,
loss 0). Each ``(N, L)`` batch reduces to per-sample scalars through one
``(N, L, L)`` 0/1 comparison; its counts are at most L, so the float32
einsums are exact.
"""
from typing import Tuple

import torch
from torch import Tensor


def _check_ranking_inputs(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    if preds.ndim != 2 or target.ndim != 2 or preds.shape != target.shape:
        raise ValueError(
            f"Expected preds and target of identical shape (N, num_labels), "
            f"got {tuple(preds.shape)} and {tuple(target.shape)}"
        )
    return preds, target.to(torch.float32)


def _pairwise_ge(preds: Tensor) -> Tensor:
    """``ge[i, j, k] = 1.0`` iff ``preds[i, k] >= preds[i, j]``."""
    return (preds[:, None, :] >= preds[:, :, None]).to(torch.float32)


def _count(n: int, like: Tensor) -> Tensor:
    return torch.tensor(n, dtype=torch.int64, device=like.device)


def _coverage_error_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    preds, r = _check_ranking_inputs(preds, target)
    ranks = _pairwise_ge(preds).sum(-1)  # rank_j = |{k: s_k >= s_j}|
    per_sample = torch.amax(r * ranks, dim=-1)  # no true labels -> 0
    return per_sample.sum(), _count(preds.shape[0], preds)


def coverage_error(preds: Tensor, target: Tensor) -> Tensor:
    """How far down the ranking one must go to cover all true labels
    (``sklearn.metrics.coverage_error``).

    Example:
        >>> import torch
        >>> preds = torch.tensor([[0.9, 0.1, 0.5], [0.2, 0.8, 0.6]])
        >>> target = torch.tensor([[1, 0, 1], [0, 1, 0]])
        >>> float(coverage_error(preds, target))
        1.5
    """
    total, n = _coverage_error_update(preds, target)
    return total / torch.clamp_min(n.to(torch.float32), 1.0)


def _label_ranking_ap_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    preds, r = _check_ranking_inputs(preds, target)
    num_labels = preds.shape[1]
    ge = _pairwise_ge(preds)
    ranks = ge.sum(-1)
    among_true = torch.einsum("njk,nk->nj", ge, r)
    n_true = r.sum(-1)
    precision = among_true / ranks  # ranks >= 1 always (self-comparison)
    raw = torch.sum(r * precision, dim=-1) / torch.clamp_min(n_true, 1.0)
    degenerate = (n_true == 0) | (n_true == num_labels)
    per_sample = torch.where(degenerate, torch.ones_like(raw), raw)
    return per_sample.sum(), _count(preds.shape[0], preds)


def label_ranking_average_precision(preds: Tensor, target: Tensor) -> Tensor:
    """Label-ranking average precision for multilabel data
    (``sklearn.metrics.label_ranking_average_precision_score``).

    Example:
        >>> import torch
        >>> preds = torch.tensor([[0.75, 0.5, 1.0], [1.0, 0.2, 0.1]])
        >>> target = torch.tensor([[1, 0, 0], [0, 0, 1]])
        >>> round(float(label_ranking_average_precision(preds, target)), 4)
        0.4167
    """
    total, n = _label_ranking_ap_update(preds, target)
    return total / torch.clamp_min(n.to(torch.float32), 1.0)


def _label_ranking_loss_update(preds: Tensor, target: Tensor) -> Tuple[Tensor, Tensor]:
    preds, r = _check_ranking_inputs(preds, target)
    num_labels = preds.shape[1]
    ge = _pairwise_ge(preds)
    n_true = r.sum(-1)
    n_false = num_labels - n_true
    # for each true label j: the false labels ranked at or above it (a tie is
    # a violation); j's self-comparison drops out since a false label has r = 0
    false_ge = torch.einsum("njk,nk->nj", ge, 1.0 - r)
    violations = torch.sum(r * false_ge, dim=-1)
    denom = n_true * n_false
    per_sample = torch.where(denom > 0, violations / torch.clamp_min(denom, 1.0), torch.zeros_like(violations))
    return per_sample.sum(), _count(preds.shape[0], preds)


def label_ranking_loss(preds: Tensor, target: Tensor) -> Tensor:
    """Average fraction of wrongly ordered (true, false) label pairs
    (``sklearn.metrics.label_ranking_loss``).

    Example:
        >>> import torch
        >>> preds = torch.tensor([[0.2, 0.8, 0.6], [0.9, 0.6, 0.5]])
        >>> target = torch.tensor([[0, 1, 0], [1, 0, 1]])
        >>> float(label_ranking_loss(preds, target))
        0.25
    """
    total, n = _label_ranking_loss_update(preds, target)
    return total / torch.clamp_min(n.to(torch.float32), 1.0)
