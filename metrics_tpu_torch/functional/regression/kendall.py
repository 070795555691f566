"""Kendall rank correlation (tau-b, tie-corrected), as ``scipy.stats.kendalltau``.

Counterpart of ``metrics_tpu/functional/regression/kendall.py``: the O(N^2)
pairwise sign contraction. XLA fuses the JAX package's two N x N sign
matrices; eager torch would build each (1 GB at N = 16,384), so the port
walks the rows in blocks, peak memory O(block x N), and counts each block's
concordance and tie sums in int64: exact, whatever the order. The counts
become tau once, at the end, in float64, and the result is float32. The JAX
package sums the same signs in float32, which is exact only while a sum
stays below 2**24.
"""
import math
from typing import Optional

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.prints import rank_zero_warn

# Beyond this length the O(N^2) contraction costs > 10^10 operations; warn rather than hang silently.
_QUADRATIC_WARN_LEN = 100_000
# elements of one block's sign matrix: the rows per block are this over N
_BLOCK_ELEMENTS = 1 << 24


def _warn_if_quadratic(n: int) -> None:
    if n > _QUADRATIC_WARN_LEN:
        rank_zero_warn(
            f"Kendall tau over {n} samples runs an O(N^2) pairwise contraction "
            f"(~{(n / 1e5) ** 2 * 10:.0f}e9 flops); expect long device times "
            "beyond ~100k accumulated samples."
        )


def _signs(block: Tensor, column: Tensor) -> Tensor:
    """``sign(block[i] - column[j])`` as int8 (equal to it for finite values)."""
    return (block > column).to(torch.int8) - (block < column).to(torch.int8)


def _kendall_kernel(preds: Tensor, target: Tensor, block_rows: Optional[int] = None) -> Tensor:
    """tau-b over 1-D float tensors; ``nan`` when degenerate or when an input is
    not finite (the JAX package's ``inf - inf`` on the diagonal gives nan)."""
    n = preds.shape[0]
    rows = block_rows or max(1, _BLOCK_ELEMENTS // max(n, 1))
    concordance = torch.zeros((), dtype=torch.int64, device=preds.device)
    ties_x = torch.zeros_like(concordance)
    ties_y = torch.zeros_like(concordance)
    for start in range(0, n, rows):
        sx = _signs(preds[start:start + rows, None], preds[None, :])
        sy = _signs(target[start:start + rows, None], target[None, :])
        concordance += torch.sum(sx * sy, dtype=torch.int64)
        ties_x += torch.sum(sx == 0, dtype=torch.int64)
        ties_y += torch.sum(sy == 0, dtype=torch.int64)
    # each pair counts twice in the full matrix, and the diagonal's n signs are ties
    s = (concordance // 2).to(torch.float64)
    n0 = n * (n - 1) // 2
    n1 = ((ties_x - n) // 2).to(torch.float64)
    n2 = ((ties_y - n) // 2).to(torch.float64)
    denom = torch.sqrt((n0 - n1) * (n0 - n2))
    ok = (denom > 0) & torch.isfinite(preds).all() & torch.isfinite(target).all()
    tau = torch.where(ok, s / torch.where(ok, denom, torch.ones_like(denom)), torch.full_like(denom, math.nan))
    return tau.to(torch.float32)


def kendall_rank_corrcoef(preds: Tensor, target: Tensor) -> Tensor:
    """Kendall's tau-b between two 1-D score sequences, as
    ``scipy.stats.kendalltau(preds, target).statistic``; ``nan`` for a constant
    input or fewer than 2 samples.

    Example:
        >>> import torch
        >>> preds = torch.tensor([1.0, 2.0, 3.0, 4.0])
        >>> target = torch.tensor([1.0, 3.0, 2.0, 4.0])
        >>> round(float(kendall_rank_corrcoef(preds, target)), 4)
        0.6667
    """
    _check_same_shape(preds, target)
    if preds.ndim != 1:
        raise ValueError("Expected both `preds` and `target` to be 1D arrays of scalar scores")
    if preds.shape[0] < 2:
        return torch.tensor(float("nan"), device=preds.device)
    _warn_if_quadratic(preds.shape[0])
    return _kendall_kernel(preds.to(torch.float32), target.to(torch.float32))
