"""Tweedie deviance score. Counterpart of ``metrics_tpu/functional/regression/tweedie.py``;
matches ``sklearn.metrics.mean_tweedie_deviance``."""
from typing import Tuple

import torch
from torch import Tensor

from metrics_tpu_torch.utils.checks import _check_same_shape


def _check_power(power: float) -> None:
    if not (power in (0, 1, 2) or 1 < power < 2):
        raise ValueError(f"`power` must be 0, 1, 2, or in (1, 2) (compound Poisson-Gamma), got {power!r}")


def _tweedie_update(preds: Tensor, target: Tensor, power: float = 0.0) -> Tuple[Tensor, int]:
    _check_same_shape(preds, target)
    _check_power(power)
    y = target.to(torch.float32).reshape(-1)
    mu = preds.to(torch.float32).reshape(-1)
    if power == 0:
        dev = (y - mu) ** 2
    elif power == 1:
        # Poisson deviance; y log(y / mu) -> 0 as y -> 0
        safe_y = torch.clamp_min(y, 1e-38)
        dev = 2.0 * (torch.where(y > 0, y * torch.log(safe_y / mu), torch.zeros_like(y)) - y + mu)
    elif power == 2:
        # Gamma deviance
        dev = 2.0 * (torch.log(mu / y) + y / mu - 1.0)
    else:
        # The three terms cancel to a deviance ~1e-3 of their size, so a last-bit difference in one
        # power shows at 1e-5. A 0-dim exponent on the tensor's device keeps torch on its general
        # pow, which rounds as XLA's does; a Python float 0.5 or -0.5 (power 1.5) takes torch's
        # sqrt/rsqrt shortcut, which rounds otherwise. It is filled on the device: no host copy.
        def _pow(x: Tensor, exponent: float) -> Tensor:
            return torch.pow(x, torch.full((), exponent, dtype=x.dtype, device=x.device))

        dev = 2.0 * (
            _pow(torch.clamp_min(y, 0.0), 2.0 - power) / ((1.0 - power) * (2.0 - power))
            - y * _pow(mu, 1.0 - power) / (1.0 - power)
            + _pow(mu, 2.0 - power) / (2.0 - power)
        )
    return torch.sum(dev), y.shape[0]


def tweedie_deviance_score(preds: Tensor, target: Tensor, power: float = 0.0) -> Tensor:
    """Mean Tweedie deviance at the given ``power``: ``0`` squared error, ``1``
    Poisson (``preds > 0``, ``target >= 0``), ``2`` Gamma (both positive), and
    values in ``(1, 2)`` the compound Poisson-Gamma family.

    Example:
        >>> import torch
        >>> preds = torch.tensor([2.0, 0.5, 1.0])
        >>> target = torch.tensor([1.5, 1.0, 1.0])
        >>> round(float(tweedie_deviance_score(preds, target, power=1)), 4)
        0.1744
    """
    total, count = _tweedie_update(preds, target, power)
    return total / max(count, 1)
