"""Character-level edit distance functional.

Counterpart of ``metrics_tpu/functional/text_edit.py``: raw Levenshtein
distance, unnormalized — unlike CER, which divides by the reference length.
The DP is host work over the strings (``functional/text.py``); the result is a
tensor on ``device``.
"""
from typing import Optional, Sequence, Union

import torch
from torch import Tensor

from metrics_tpu_torch.functional.text import _np_edit_distance
from metrics_tpu_torch.utils.device import resolve_device


def edit_distance(
    preds: Union[str, Sequence[str]],
    target: Union[str, Sequence[str]],
    reduction: Optional[str] = "mean",
    device: Optional[Union[str, torch.device]] = None,
) -> Tensor:
    """Character-level Levenshtein distance between sentence pairs.

    ``reduction``: ``"mean"`` (average distance per pair), ``"sum"``, or
    ``None`` (per-pair vector). ``device``: where the result lives (``None``: ``cuda``).

    Example:
        >>> float(edit_distance(["abcd"], ["abce"], device="cpu"))
        1.0
        >>> [float(v) for v in edit_distance(["ab", "xyz"], ["ac", "xyz"], reduction=None, device="cpu")]
        [1.0, 0.0]
    """
    if reduction not in ("mean", "sum", None):
        raise ValueError(f"`reduction` must be 'mean', 'sum' or None, got {reduction!r}")
    preds = [preds] if isinstance(preds, str) else list(preds)
    target = [target] if isinstance(target, str) else list(target)
    if len(preds) != len(target):
        raise ValueError(f"preds has {len(preds)} sentences, target {len(target)}")
    dists = torch.tensor(
        [_np_edit_distance(list(p), list(t)) for p, t in zip(preds, target)], dtype=torch.float32
    ).to(resolve_device(device))
    if reduction == "mean":
        return torch.mean(dists) if dists.shape[0] else torch.tensor(float("nan"), device=dists.device)
    if reduction == "sum":
        return torch.sum(dists)
    return dists
