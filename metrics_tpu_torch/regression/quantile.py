"""Quantile / Percentile modules: the latency / distribution metric family.

Counterpart of ``metrics_tpu/regression/quantile.py``. The metrics keep one
constant-memory :class:`~metrics_tpu_torch.parallel.qsketch.QuantileSketch`
(log-bucketed, relative accuracy ``alpha``): ``update`` is one scatter, the
sync one ``all_reduce`` in the int64 sum bucket, and ``compute`` answers any
quantile within relative error ``alpha`` with a certificate
(:meth:`Quantile.error_bound`).
"""
from typing import Any, Callable, Optional, Sequence, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.parallel.qsketch import (
    QSKETCH_ALPHA,
    QSKETCH_MAX_VALUE,
    QSKETCH_MIN_VALUE,
    QuantileSketch,
    qsketch_update,
    qsketch_value_group_key,
    quantile_error_bound,
    quantile_from_counts,
    quantile_sketch_spec,
)

__all__ = ["Percentile", "Quantile"]


def _canonical_q(q: Union[float, Sequence[float]]) -> Union[float, tuple]:
    """Validate ``q`` into a float or a tuple of floats (hashable config)."""
    if np.ndim(q) == 0:
        qf = float(q)
        if not 0.0 <= qf <= 1.0:
            raise ValueError(f"`q` must be in [0, 1], got {q!r}")
        return qf
    qs = tuple(float(v) for v in np.asarray(q).reshape(-1))
    if not qs:
        raise ValueError("`q` must name at least one quantile")
    if any(not 0.0 <= v <= 1.0 for v in qs):
        raise ValueError(f"every `q` must be in [0, 1], got {q!r}")
    return qs


class Quantile(Metric):
    r"""Accumulated quantile(s) of a value stream, to relative accuracy ``alpha``.

    Args:
        q: the quantile(s) to report: a float in ``[0, 1]`` (a scalar
            ``compute()``) or a sequence (a vector ``compute()``, one synced
            sketch answering all of them). ``q`` is compute-only: Quantile and
            Percentile instances with equal grid config share one compute
            group inside a ``MetricCollection``.
        alpha: relative accuracy of the log-bucketed grid.
        min_value / max_value: the certified magnitude span. Magnitudes below
            ``min_value`` report exactly 0.0; values beyond ``max_value`` land
            in the signed overflow buckets, counted and ordered but flagged by
            :meth:`error_bound`.
        device: where the sketch lives; ``None`` means ``cuda``.

    NaN values are dropped; ``±inf`` lands in the overflow buckets.
    ``compute()`` is ``nan`` on an empty sketch.

    Example:
        >>> import torch
        >>> latency = Quantile(q=0.99, device="cpu")
        >>> latency.update(torch.tensor([0.12, 0.31, 0.09, 4.2]))
        >>> round(float(latency.compute()), 2)
        4.2
    """

    def __init__(
        self,
        q: Union[float, Sequence[float]] = 0.5,
        alpha: float = QSKETCH_ALPHA,
        min_value: float = QSKETCH_MIN_VALUE,
        max_value: float = QSKETCH_MAX_VALUE,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(
            compute_on_step=compute_on_step,
            dist_sync_on_step=dist_sync_on_step,
            process_group=process_group,
            dist_sync_fn=dist_sync_fn,
            device=device,
        )
        self.q = _canonical_q(q)
        spec = quantile_sketch_spec(alpha, min_value, max_value)
        self.alpha = spec.alpha
        self.min_value = spec.min_value
        self.max_value = spec.max_value
        self.add_state("qsketch", default=spec, dist_reduce_fx="sum")

    def update(self, values: Tensor) -> None:
        """Fold one batch of raw values (any shape, raveled) into the sketch."""
        self.qsketch = QuantileSketch(
            qsketch_update(self.qsketch.counts, torch.as_tensor(values, device=self.device), self.alpha,
                           self.min_value, self.max_value)
        )

    def _group_fingerprint(self) -> Optional[Any]:
        # q is compute-only: equal-grid Quantile / Percentile instances share
        # one scatter and one synced sketch
        return qsketch_value_group_key(self)

    def compute(self) -> Tensor:
        return quantile_from_counts(self.qsketch.counts, self.q, self.alpha, self.min_value, self.max_value)

    def error_bound(self) -> Tensor:
        """Certificate for the current :meth:`compute` value: relative bound
        ``alpha`` per quantile (``|estimate - true| <= alpha * |true| +
        min_value``) where the rank resolves inside the certified span, ``inf``
        where it resolves in an overflow bucket."""
        return quantile_error_bound(self.qsketch.counts, self.q, self.alpha, self.min_value, self.max_value)

    def __repr__(self) -> str:
        return f"{self.__class__.__name__}(q={self.q!r}, alpha={self.alpha!r})"


class Percentile(Quantile):
    """:class:`Quantile` on the 0-100 scale: ``Percentile(99)`` is
    ``Quantile(q=0.99)`` (same state, same compute group, same certificate)."""

    def __init__(
        self,
        p: Union[float, Sequence[float]] = 50.0,
        alpha: float = QSKETCH_ALPHA,
        min_value: float = QSKETCH_MIN_VALUE,
        max_value: float = QSKETCH_MAX_VALUE,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        if np.ndim(p) == 0:
            q: Union[float, tuple] = float(p) / 100.0
        else:
            q = tuple(float(v) / 100.0 for v in np.asarray(p).reshape(-1))
        super().__init__(
            q=q, alpha=alpha, min_value=min_value, max_value=max_value,
            compute_on_step=compute_on_step, dist_sync_on_step=dist_sync_on_step,
            process_group=process_group, dist_sync_fn=dist_sync_fn, device=device,
        )
