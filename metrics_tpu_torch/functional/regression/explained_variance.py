"""Explained variance from five summed moments.

Counterpart of ``metrics_tpu/functional/regression/explained_variance.py``. The
variances are the reference's raw-moment form ``E[x^2] - E[x]^2`` in float32,
kept as the JAX package has it (ROADMAP section 3).
"""
from typing import Sequence, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape
from metrics_tpu_torch.utils.data import upcast_accum


def _explained_variance_update(preds: Tensor, target: Tensor) -> Tuple[int, Tensor, Tensor, Tensor, Tensor]:
    _check_same_shape(preds, target)
    preds, target = upcast_accum(preds), upcast_accum(target)
    diff = target - preds
    return (
        preds.shape[0],
        torch.sum(diff, dim=0),
        torch.sum(diff**2, dim=0),
        torch.sum(target, dim=0),
        torch.sum(target**2, dim=0),
    )


def _explained_variance_compute(
    n_obs: Union[int, Tensor],
    sum_error: Tensor,
    sum_squared_error: Tensor,
    sum_target: Tensor,
    sum_squared_target: Tensor,
    multioutput: str = "uniform_average",
) -> Union[Tensor, Sequence[Tensor]]:
    diff_avg = sum_error / n_obs
    numerator = sum_squared_error / n_obs - diff_avg**2
    target_avg = sum_target / n_obs
    denominator = sum_squared_target / n_obs - target_avg**2

    # as sklearn: 1.0 when both are zero, 0.0 when only the denominator is
    nonzero_numerator = numerator != 0
    nonzero_denominator = denominator != 0
    safe_denom = torch.where(nonzero_denominator, denominator, torch.ones_like(denominator))
    output_scores = torch.ones_like(diff_avg)
    output_scores = torch.where(nonzero_numerator & nonzero_denominator, 1.0 - numerator / safe_denom, output_scores)
    output_scores = torch.where(nonzero_numerator & ~nonzero_denominator, torch.zeros_like(output_scores),
                                output_scores)

    if multioutput == "raw_values":
        return output_scores
    if multioutput == "uniform_average":
        return torch.mean(output_scores)
    if multioutput == "variance_weighted":
        return torch.sum(denominator / torch.sum(denominator) * output_scores)
    raise ValueError(f"Invalid input to multioutput: {multioutput}")


def explained_variance(
    preds: Tensor,
    target: Tensor,
    multioutput: str = "uniform_average",
) -> Union[Tensor, Sequence[Tensor]]:
    """Explained variance: ``1 - Var(target - preds) / Var(target)``.

    Example:
        >>> import torch
        >>> target = torch.tensor([3, -0.5, 2, 7])
        >>> preds = torch.tensor([2.5, 0.0, 2, 8])
        >>> round(float(explained_variance(preds, target)), 4)
        0.9572
        >>> target = torch.tensor([[0.5, 1], [-1, 1], [7, -6]])
        >>> preds = torch.tensor([[0., 2], [-1, 2], [8, -5]])
        >>> [round(float(v), 4) for v in explained_variance(preds, target, multioutput='raw_values')]
        [0.9677, 1.0]
    """
    return _explained_variance_compute(*_explained_variance_update(preds, target), multioutput)
