"""Permutation-invariant training (PIT). Counterpart of ``metrics_tpu/functional/audio/pit.py``.

The pairwise metric matrix is evaluated once (``S x S`` pairs, batched over
examples) and every permutation's score is one gather over it. The ``(S!, S)``
permutation table is built on the host once per S and kept on each device.
"""
import itertools
from typing import Callable, Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import device_constant


def _permutations(s: int, device: torch.device) -> Tensor:
    """``(S!, S)`` int64 permutations of ``range(S)`` in ``itertools`` order, on ``device``."""
    return device_constant(("pit_permutations", s), device, lambda: list(itertools.permutations(range(s))), torch.int64)


def _pairwise_matrix(preds: Tensor, target: Tensor, metric_func: Callable) -> Tensor:
    """(B, S, S) matrix of metric_func(preds[:, i], target[:, j])."""
    b, s, t = preds.shape
    # expand to all (i, j) pairs; metric_func reduces the trailing time axis
    p = preds[:, :, None, :].expand(b, s, s, t)
    tt = target[:, None, :, :].expand(b, s, s, t)
    return metric_func(p, tt)  # (B, S, S)


def permutation_invariant_training(
    preds: Tensor,
    target: Tensor,
    metric_func: Callable,
    eval_func: str = "max",
) -> Tuple[Tensor, Tensor]:
    """Best per-example metric over all source permutations.

    Args:
        preds: ``(B, S, T)`` estimated sources.
        target: ``(B, S, T)`` reference sources.
        metric_func: per-example function reducing the trailing time axis,
            e.g. ``lambda p, t: _si_sdr_per_example(p, t, False)``, called
            once on broadcast ``(B, S, S, T)`` pairs.
        eval_func: ``"max"`` (higher is better, e.g. SI-SDR) or ``"min"``
            (lower is better, e.g. a loss).

    Returns:
        ``(best_metric, best_perm)``: ``(B,)`` best mean-over-sources value
        and ``(B, S)`` the permutation achieving it (``preds[b, perm[b, s]]``
        pairs with ``target[b, s]``); a tie goes to the first permutation in
        ``itertools`` order.

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional.audio.si_sdr import _si_sdr_per_example
        >>> a = torch.sin(torch.arange(16.0))[None, :].repeat(2, 1)
        >>> b = torch.cos(3 * torch.arange(16.0))[None, :].repeat(2, 1)
        >>> target = torch.stack([a, b], dim=1)
        >>> preds = target.flip(1)  # swapped sources
        >>> best, perm = permutation_invariant_training(
        ...     preds, target, lambda p, t: _si_sdr_per_example(p, t, False))
        >>> perm[0].tolist()
        [1, 0]
    """
    if eval_func not in ("max", "min"):
        raise ValueError(f"`eval_func` must be 'max' or 'min', got {eval_func!r}")
    _check_same_shape(preds, target)
    if preds.ndim != 3:
        raise ValueError(f"`preds` and `target` must be (batch, sources, time), got shape {tuple(preds.shape)}")
    s = preds.shape[1]
    mat = _pairwise_matrix(preds, target, metric_func)  # (B, S, S)
    perms = _permutations(s, mat.device)  # (S!, S)
    cols = torch.arange(s, device=mat.device)
    # score of perm p = mean_s mat[:, p[s], s]; one gather over all S! perms
    perm_scores = torch.mean(mat[:, perms, cols], dim=-1)  # (B, S!)
    best_idx = torch.argmax(perm_scores, dim=1) if eval_func == "max" else torch.argmin(perm_scores, dim=1)
    best_metric = torch.gather(perm_scores, 1, best_idx[:, None])[:, 0]
    return best_metric, perms[best_idx]


def pit_permutate(preds: Tensor, perm: Tensor) -> Tensor:
    """Reorder ``(B, S, T)`` sources by the ``(B, S)`` permutation PIT found."""
    return torch.gather(preds, 1, perm.to(torch.int64)[:, :, None].expand(-1, -1, preds.shape[-1]))
