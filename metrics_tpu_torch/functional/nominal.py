"""Nominal (categorical-categorical) association metrics.

Counterpart of ``metrics_tpu/functional/nominal.py``. All four are closed
forms of the contingency matrix the clustering family streams
(:func:`~metrics_tpu_torch.functional.clustering._contingency`), computed in
float64 from its int64 counts and rounded once to float32 (the JAX package
works in float32):

* ``cramers_v``: chi-squared based, optional bias correction (Bergsma 2013),
  ``scipy.stats.contingency.association(..., 'cramer')``;
* ``pearsons_contingency_coefficient``: ``sqrt(chi2 / (chi2 + n))``;
* ``tschuprows_t``: chi-squared normalized by ``sqrt((r-1)(c-1))``;
* ``theils_u``: the asymmetric uncertainty coefficient
  ``U(target|preds) = (H(target) - H(target|preds)) / H(target)``.
"""
from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.functional.clustering import _contingency, _entropy


def _chi2(cont: Tensor) -> Tensor:
    cont = cont.to(torch.float64)
    n = cont.sum()
    expected = cont.sum(1, keepdim=True) * cont.sum(0, keepdim=True) / torch.clamp(n, min=1.0)
    terms = (cont - expected) ** 2 / torch.clamp(expected, min=1e-30)
    return torch.sum(torch.where(expected > 0, terms, torch.zeros_like(terms)))


def _effective_dims(cont: Tensor) -> Tuple[Tensor, Tensor]:
    """Populated row / column counts (empty rows and columns excluded, as in scipy / pandas)."""
    r = (cont.sum(1) > 0).sum().to(torch.float64)
    c = (cont.sum(0) > 0).sum().to(torch.float64)
    return r, c


def _sqrt_ratio(num: Tensor, den: Tensor) -> Tensor:
    """``sqrt(num / den)`` in float32 where ``den > 0``, else NaN."""
    ok = den > 0
    value = torch.sqrt(num / torch.where(ok, den, torch.ones_like(den)))
    return torch.where(ok, value, torch.full_like(value, float("nan"))).to(torch.float32)


def _cramers_v_compute(cont: Tensor, bias_correction: bool = False) -> Tensor:
    chi2 = _chi2(cont)
    n = cont.sum().to(torch.float64)
    r, c = _effective_dims(cont)
    if bias_correction:
        n1 = torch.clamp(n - 1.0, min=1.0)
        phi2 = chi2 / torch.clamp(n, min=1.0)
        phi2c = torch.clamp(phi2 - (r - 1.0) * (c - 1.0) / n1, min=0.0)
        rc = r - (r - 1.0) ** 2 / n1
        cc = c - (c - 1.0) ** 2 / n1
        return _sqrt_ratio(phi2c, torch.minimum(rc, cc) - 1.0)
    return _sqrt_ratio(chi2, n * (torch.minimum(r, c) - 1.0))


def _pearson_cc_compute(cont: Tensor) -> Tensor:
    chi2 = _chi2(cont)
    n = cont.sum().to(torch.float64)
    return torch.sqrt(chi2 / torch.clamp(chi2 + n, min=1e-30)).to(torch.float32)


def _tschuprows_t_compute(cont: Tensor) -> Tensor:
    chi2 = _chi2(cont)
    n = cont.sum().to(torch.float64)
    r, c = _effective_dims(cont)
    return _sqrt_ratio(chi2, n * torch.sqrt(torch.clamp((r - 1.0) * (c - 1.0), min=0.0)))


def _theils_u_compute(cont: Tensor) -> Tensor:
    """U(target | preds): how much knowing preds reduces target entropy."""
    cont = cont.to(torch.float64)
    n = cont.sum()
    h_target = _entropy(cont.sum(0))
    # conditional entropy H(target | preds) = sum_rows p_row * H(row)
    row_tot = cont.sum(1)
    p_rows = cont / torch.clamp(row_tot[:, None], min=1.0)
    pos = p_rows > 0
    h_rows = -torch.sum(torch.where(pos, p_rows * torch.log(torch.where(pos, p_rows, torch.ones_like(p_rows))),
                                    torch.zeros_like(p_rows)), dim=1)
    weighted = (row_tot / torch.clamp(n, min=1.0)) * h_rows
    h_cond = torch.sum(torch.where(row_tot > 0, weighted, torch.zeros_like(weighted)))
    ok = h_target > 0
    value = (h_target - h_cond) / torch.where(ok, h_target, torch.ones_like(h_target))
    return torch.where(ok, value, torch.ones_like(value)).to(torch.float32)


def cramers_v(
    preds: Tensor, target: Tensor, num_classes_preds: int, num_classes_target: int,
    bias_correction: bool = False,
) -> Tensor:
    """Cramer's V association between two categorical variables
    (``scipy.stats.contingency.association(..., method='cramer')``);
    ``bias_correction=True`` applies the Bergsma small-sample correction.

    Example:
        >>> import torch
        >>> preds = torch.tensor([0, 0, 1, 1, 2, 2])
        >>> target = torch.tensor([0, 0, 1, 1, 2, 2])
        >>> round(float(cramers_v(preds, target, 3, 3)), 4)
        1.0
    """
    return _cramers_v_compute(_contingency(preds, target, num_classes_preds, num_classes_target), bias_correction)


def pearsons_contingency_coefficient(
    preds: Tensor, target: Tensor, num_classes_preds: int, num_classes_target: int
) -> Tensor:
    """Pearson's contingency coefficient (``scipy.stats.contingency.association(..., method='pearson')``).

    Example:
        >>> import torch
        >>> preds = torch.tensor([0, 0, 1, 1])
        >>> target = torch.tensor([0, 0, 1, 1])
        >>> round(float(pearsons_contingency_coefficient(preds, target, 2, 2)), 4)
        0.7071
    """
    return _pearson_cc_compute(_contingency(preds, target, num_classes_preds, num_classes_target))


def tschuprows_t(
    preds: Tensor, target: Tensor, num_classes_preds: int, num_classes_target: int
) -> Tensor:
    """Tschuprow's T association (``scipy.stats.contingency.association(..., method='tschuprow')``).

    Example:
        >>> import torch
        >>> preds = torch.tensor([0, 0, 1, 1, 2, 2])
        >>> target = torch.tensor([0, 0, 1, 1, 2, 2])
        >>> round(float(tschuprows_t(preds, target, 3, 3)), 4)
        1.0
    """
    return _tschuprows_t_compute(_contingency(preds, target, num_classes_preds, num_classes_target))


def theils_u(
    preds: Tensor, target: Tensor, num_classes_preds: int, num_classes_target: int
) -> Tensor:
    """Theil's U (uncertainty coefficient), asymmetric: how much knowing
    ``preds`` reduces the entropy of ``target``.

    Example:
        >>> import torch
        >>> preds = torch.tensor([0, 0, 1, 1])
        >>> target = torch.tensor([0, 0, 1, 1])
        >>> round(float(theils_u(preds, target, 2, 2)), 4)
        1.0
    """
    return _theils_u_compute(_contingency(preds, target, num_classes_preds, num_classes_target))
