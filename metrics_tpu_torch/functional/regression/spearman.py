"""Spearman rank correlation: tie-averaged ranks of both inputs, then Pearson on the ranks.

Counterpart of ``metrics_tpu/functional/regression/spearman.py``. A run of
tied values shares the average of its 1-based sorted positions. The JAX
package averages with a float32 ``segment_sum`` of the positions; here a
run's average is ``(first + last) / 2 + 1`` from its first and last sorted
positions, found by ``searchsorted`` over the run ids: no float atomics, so
the ranks do not depend on the order of additions on the card, and exact in
float32 below 2**23 samples (``first + last < 2**24``). It equals the JAX
value wherever that float32 sum is exact. The correlation of the ranks is
the reference's raw-moment form in float32 (ROADMAP section 3), but for its
denominator: ``sqrt(var_x) * sqrt(var_y)`` in place of the JAX package's
``sqrt(var_x * var_y)``, which overflows float32 from about 122,000 samples
and makes the JAX package return 0 there (ROADMAP section 3).
"""
import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape


def _rank_data(x: Tensor) -> Tensor:
    """1-based float32 ranks, ties given their average rank (scipy's default).
    Every NaN is a run of its own and sorts last, as ``jnp.argsort`` puts it."""
    n = x.shape[0]
    # one NaN bit pattern: the card's radix sort would put a NaN with its sign bit set first
    x = torch.where(torch.isnan(x), torch.full_like(x, float("nan")), x)
    sorted_x, order = torch.sort(x, stable=True)
    new_run = torch.ones(n, dtype=torch.int64, device=x.device)
    new_run[1:] = (sorted_x[1:] != sorted_x[:-1]).to(torch.int64)
    run_id = torch.cumsum(new_run, 0)
    first = torch.searchsorted(run_id, run_id, side="left")
    last = torch.searchsorted(run_id, run_id, side="right") - 1
    avg = (first + last).to(torch.float32) / 2 + 1
    return torch.empty_like(avg).scatter_(0, order, avg)


def _spearman_kernel(preds: Tensor, target: Tensor) -> Tensor:
    rx = _rank_data(preds.to(torch.float32))
    ry = _rank_data(target.to(torch.float32))
    n = rx.shape[0]
    sx, sy = torch.sum(rx), torch.sum(ry)
    cov = n * torch.sum(rx * ry) - sx * sy
    var_x = n * torch.sum(rx * rx) - sx**2
    var_y = n * torch.sum(ry * ry) - sy**2
    # the product of the roots: the JAX package's root of the product overflows float32 once
    # var_x * var_y > 3.4e38 (about 122,000 samples) and returns 0 there
    denom = torch.sqrt(torch.clamp_min(var_x, 0.0)) * torch.sqrt(torch.clamp_min(var_y, 0.0))
    zero = denom == 0  # a constant input: nan, scipy's convention
    return torch.where(zero, torch.full_like(denom, float("nan")), cov / torch.where(zero, torch.ones_like(denom), denom))


def spearman_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Spearman rank correlation between two 1-D tensors.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 1.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 1.5])
        >>> float(spearman_corrcoef(preds, target))
        1.0
    """
    _check_same_shape(preds, target)
    if preds.ndim != 1:
        raise ValueError("Expected both `preds` and `target` to be 1D arrays of scalar predictions")
    if preds.shape[0] == 0:
        return torch.tensor(float("nan"), device=preds.device)  # scipy's value for no data
    return _spearman_kernel(preds, target)
