"""Pearson correlation coefficient over a ``(6,)`` co-moment vector.

Counterpart of ``metrics_tpu/functional/regression/pearson.py``. The state is
``[n, mean_x, mean_y, M2x, M2y, Cxy]`` in float32: each batch's moments are
centred on the batch's own mean, and batches and ranks combine by the Chan et
al. parallel update (:func:`chan_merge`), an associative fold, so a rank sync
is one gather and :func:`chan_fold`. The centred moments never carry the
``mean^2`` magnitude, so ``Cxy / sqrt(M2x M2y)`` does not cancel.

``n`` rides in the float32 vector (the merge needs it with the means), and a
float32 count stops growing at 2**24; ``PearsonCorrcoef`` keeps the exact count
in an int64 state and warns past that point.
"""
import torch
from torch import Tensor

from metrics_tpu_torch.parallel.sync import associative
from metrics_tpu_torch.utils.checks import _check_same_shape

# co-moment vector layout
_N, _MX, _MY, _M2X, _M2Y, _CXY = range(6)


def batch_comoments(preds: Tensor, target: Tensor) -> Tensor:
    """Co-moment vector of one batch, centred on the batch's own mean."""
    _check_same_shape(preds, target)
    if preds.ndim != 1:
        raise ValueError("Expected both `preds` and `target` to be 1D arrays of scalar predictions")
    x, y = preds.to(torch.float32), target.to(torch.float32)
    n = x.shape[0]
    if n == 0:
        return torch.zeros(6, dtype=torch.float32, device=x.device)
    mx, my = torch.mean(x), torch.mean(y)
    dx, dy = x - mx, y - my
    return torch.stack([
        torch.full((), float(n), dtype=torch.float32, device=x.device),  # a fill, not a host-to-device copy
        mx,
        my,
        torch.sum(dx * dx),
        torch.sum(dy * dy),
        torch.sum(dx * dy),
    ])


def chan_merge(a: Tensor, b: Tensor) -> Tensor:
    """Pairwise merge of two co-moment vectors (Chan et al. parallel update);
    exact when either side is empty."""
    na, nb = a[_N], b[_N]
    n = na + nb
    nsafe = torch.where(n == 0, torch.ones_like(n), n)
    dx = b[_MX] - a[_MX]
    dy = b[_MY] - a[_MY]
    f = nb / nsafe
    w = na * nb / nsafe
    return torch.stack([
        n,
        a[_MX] + dx * f,
        a[_MY] + dy * f,
        a[_M2X] + b[_M2X] + dx * dx * w,
        a[_M2Y] + b[_M2Y] + dy * dy * w,
        a[_CXY] + b[_CXY] + dx * dy * w,
    ])


@associative
def chan_fold(stacked: Tensor) -> Tensor:
    """Fold a ``(world, 6)`` stack of co-moment vectors into one, in rank order."""
    out = stacked[0]
    for i in range(1, stacked.shape[0]):
        out = chan_merge(out, stacked[i])
    return out


def comoments_corrcoef(c: Tensor) -> Tensor:
    """r from a co-moment vector; ``nan`` when either variance is zero (scipy's convention).
    The denominator is the product of the roots, which stays finite where the JAX package's root
    of the product overflows float32 (``M2x * M2y > 3.4e38``) and returns 0."""
    denom = torch.sqrt(torch.clamp_min(c[_M2X], 0.0)) * torch.sqrt(torch.clamp_min(c[_M2Y], 0.0))
    zero = denom == 0
    safe = torch.where(zero, torch.ones_like(denom), denom)
    return torch.where(zero, torch.full_like(denom, float("nan")), c[_CXY] / safe)


def pearson_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Pearson correlation between two 1-D tensors; ``nan`` when either has zero variance.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 7.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 8.0])
        >>> round(float(pearson_corrcoef(preds, target)), 4)
        0.9849
    """
    return comoments_corrcoef(batch_comoments(preds, target))
