"""Mergeable quantile sketches: the latency / distribution state kind.

Counterpart of ``metrics_tpu/parallel/qsketch.py``. A :class:`QuantileSketch`
is one integer counts tensor over a fixed log-bucketed grid of relative
accuracy ``alpha`` (DDSketch-style): bucket ``j`` covers ``[min_value *
gamma^j, min_value * gamma^(j+1))`` with ``gamma = (1 + alpha) / (1 - alpha)``,
so the bucket's multiplicative midpoint answers any quantile within relative
error ``alpha``. Grid layout, ``m`` log buckets a sign, ``B = 2 m + 3``::

    index 0            : negative overflow   (x <= -min_value * gamma^m)
    index 1 .. m       : negative log buckets (ascending in x)
    index m + 1        : zero bucket          (|x| < min_value)
    index m + 2 .. 2m+1: positive log buckets
    index 2 m + 2      : positive overflow    (x >= min_value * gamma^m)

The index map is strictly monotone, so the same grid bins the curve
histograms (``approx="qsketch"`` of AUROC / AveragePrecision: raw logits, no
``sketch_range``) and the joint rank histograms (range-free Spearman /
Kendall). Merge is elementwise integer addition; the sync rides the int64 sum
bucket. NaN samples are dropped (a zero increment); ``±inf`` lands in the
signed overflow buckets.

**Binning by comparison.** The JAX package buckets with ``floor(log(|x| /
min_value) / log(gamma))`` in float32, and ``log`` in float32 is not the same
function in XLA's CPU backend, in torch's CPU build and in CUDA's ``logf``.
Here the ``m + 1`` bucket edges ``min_value * gamma^k`` are computed once a
grid in float64 on the host, rounded *up* to float32 (so ``|x| >= edge32``
holds exactly when ``|x| >= edge`` for every float32 ``|x|``), cached on each
device, and a value's bucket is ``m + 1 + sign(x) * k`` with ``k`` the number
of edges at or below ``|x|`` (one ``searchsorted``). Every value then lands in
its float64-exact bucket, on the CPU and on the card alike, bit for bit. It
differs from the JAX package only for values within a few ulps of an edge,
where the JAX package's ``log`` itself leaves the exact bucket; such a value
moves by one bucket (ROADMAP section 3).
"""
import functools
import math
from typing import Any, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.utils.data import accum_int_dtype, device_constant, scatter_count

__all__ = [
    "QSKETCH_ALPHA",
    "QSKETCH_CURVE_ALPHA",
    "QSKETCH_CURVE_RANGE",
    "QSKETCH_MAX_VALUE",
    "QSKETCH_MIN_VALUE",
    "QSKETCH_RANK_ALPHA",
    "QSKETCH_RANK_RANGE",
    "QSketchSpec",
    "QuantileSketch",
    "is_qsketch",
    "is_qsketch_spec",
    "qsketch_bucket",
    "qsketch_bucket_edges",
    "qsketch_bucket_values",
    "qsketch_curve_group_key",
    "qsketch_curve_spec",
    "qsketch_curve_update",
    "qsketch_init",
    "qsketch_merge",
    "qsketch_nbytes",
    "qsketch_num_buckets",
    "qsketch_rank_group_key",
    "qsketch_rank_spec",
    "qsketch_rank_update",
    "qsketch_update",
    "qsketch_value_group_key",
    "quantile_error_bound",
    "quantile_from_counts",
    "quantile_sketch_spec",
]

# defaults of record, as in the JAX package: the plain grid spans 18 decades at
# 1% relative accuracy; the curve grid 12 decades; the rank grid trades accuracy
# for the joint histogram's quadratic size (alpha = 0.1: a 279 x 279 joint)
QSKETCH_ALPHA = 0.01
QSKETCH_MIN_VALUE = 1e-9
QSKETCH_MAX_VALUE = 1e9
QSKETCH_CURVE_ALPHA = 0.01
QSKETCH_CURVE_RANGE = (1e-6, 1e6)
QSKETCH_RANK_ALPHA = 0.1
QSKETCH_RANK_RANGE = (1e-6, 1e6)

# a rank spec's joint histogram is (B, B): cap B so a mistyped alpha cannot
# request a multi-GB state
_MAX_RANK_GRID = 4096


class QuantileSketch(NamedTuple):
    """Log-bucketed quantile sketch state: one ``(..., B)`` integer counts
    tensor. Layouts: ``(B,)`` for a value sketch, ``(2, B)`` / ``(C, 2, B)``
    for curve histograms on the qsketch grid, ``(B, B)`` for the joint rank
    histogram."""

    counts: Tensor


def is_qsketch(value: Any) -> bool:
    return isinstance(value, QuantileSketch)


class QSketchSpec(NamedTuple):
    """Quantile-sketch state declaration (what ``Metric.add_state`` records).

    ``kind``: ``"q"`` (a ``(B,)`` value sketch), ``"hist"`` (the ``(..., 2, B)``
    curve layout) or ``"rank"`` (the ``(B, B)`` joint). ``alpha`` is the
    relative accuracy, ``min_value`` / ``max_value`` the magnitude span of the
    log grid. Pure config, fingerprintable: config-equal qsketch metrics share
    compute groups.
    """

    kind: str
    shape: Tuple[int, ...]
    dtype: Any
    alpha: float
    min_value: float
    max_value: float


def is_qsketch_spec(value: Any) -> bool:
    return isinstance(value, QSketchSpec)


def qsketch_init(spec: QSketchSpec, device: Optional[Union[str, torch.device]] = None) -> QuantileSketch:
    """Fresh zero-count qsketch for ``spec`` on ``device``."""
    return QuantileSketch(torch.zeros(spec.shape, dtype=spec.dtype, device=device))


def qsketch_merge(a: QuantileSketch, b: QuantileSketch) -> QuantileSketch:
    """Pairwise merge: elementwise integer addition, bit-exact."""
    return QuantileSketch(a.counts + b.counts)


def qsketch_nbytes(value: QuantileSketch) -> int:
    """State bytes of one qsketch (traffic-independent)."""
    return value.counts.numel() * value.counts.element_size()


# ---------------------------------------------------------------- the grid
def _validate_grid(alpha: float, min_value: float, max_value: float) -> None:
    if not (isinstance(alpha, float) and 0.0 < alpha < 1.0):
        raise ValueError(f"`alpha` must be a float in (0, 1), got {alpha!r}")
    if not (0.0 < min_value < max_value):
        raise ValueError(
            f"qsketch magnitude span must satisfy 0 < min_value < max_value,"
            f" got ({min_value!r}, {max_value!r})"
        )


def _grid_params(alpha: float, min_value: float, max_value: float) -> Tuple[int, float]:
    """``(m, gamma)``: log buckets a sign and the bucket growth factor."""
    _validate_grid(alpha, min_value, max_value)
    gamma = (1.0 + alpha) / (1.0 - alpha)
    m = int(math.ceil(math.log(max_value / min_value) / math.log(gamma)))
    return max(m, 1), gamma


def qsketch_num_buckets(alpha: float, min_value: float, max_value: float) -> int:
    """Total grid size ``B = 2 m + 3``."""
    m, _ = _grid_params(alpha, min_value, max_value)
    return 2 * m + 3


@functools.lru_cache(maxsize=None)
def qsketch_bucket_edges(alpha: float, min_value: float, max_value: float) -> np.ndarray:
    """The ``m + 1`` magnitude edges ``min_value * gamma^k`` (``k = 0 .. m``;
    the first is the zero bucket's bound, the last the overflow's), computed in
    float64 and rounded up to float32: for any float32 ``v``, ``v >= edge32``
    holds exactly when ``v >= edge``. Host numpy, read-only."""
    m, gamma = _grid_params(alpha, min_value, max_value)
    exact = min_value * gamma ** np.arange(m + 1, dtype=np.float64)
    edges = exact.astype(np.float32)
    low = edges.astype(np.float64) < exact
    edges[low] = np.nextafter(edges[low], np.float32(np.inf))
    edges.setflags(write=False)
    return edges


def qsketch_bucket(x: Tensor, alpha: float, min_value: float, max_value: float) -> Tensor:
    """Strictly monotone int64 bucket index of ``x`` (cast to float32) on the
    qsketch grid: ``m + 1 + sign(x) * k``, ``k`` the number of edges at or
    below ``|x|``. ``±inf`` lands in the signed overflow buckets; zeros and
    magnitudes below ``min_value`` in the zero bucket. NaN has no bucket:
    callers mask it first, as every update here does."""
    m, _ = _grid_params(alpha, min_value, max_value)
    xf = torch.as_tensor(x).to(torch.float32)
    edges = device_constant(("qsketch edges", alpha, min_value, max_value), xf.device,
                            lambda: qsketch_bucket_edges(alpha, min_value, max_value), torch.float32)
    k = torch.searchsorted(edges, xf.abs(), right=True)
    return (m + 1) + torch.sign(xf).to(torch.int64) * k


def qsketch_bucket_values(alpha: float, min_value: float, max_value: float) -> np.ndarray:
    """The ``(B,)`` representative value of each bucket (host float64): the
    multiplicative midpoint ``2 gamma / (gamma + 1)`` of each log bucket's
    span, exactly 0.0 for the zero bucket, ``±top * gamma`` for the overflow
    buckets (one bucket beyond the certified span)."""
    m, gamma = _grid_params(alpha, min_value, max_value)
    rep = min_value * gamma ** np.arange(m, dtype=np.float64) * (2.0 * gamma / (gamma + 1.0))
    vals = np.zeros(2 * m + 3, dtype=np.float64)
    vals[m + 2 : 2 * m + 2] = rep
    vals[1 : m + 1] = -rep[::-1]  # vals[m - j] == -rep[j]: monotone ascending
    top = min_value * gamma**m
    vals[0] = -top * gamma
    vals[2 * m + 2] = top * gamma
    return vals


# ------------------------------------------------------------------- updates
def _masked(x: Tensor) -> Tuple[Tensor, Tensor]:
    """``(x as float32 with NaN replaced by 0, keep flags)``."""
    xf = x.to(torch.float32)
    nan = torch.isnan(xf)
    return torch.where(nan, 0.0, xf), ~nan


def curve_histogram_scatter(counts: Tensor, bins: Tensor, keep: Tensor, target: Tensor, pos_label: int,
                            what: str) -> Tensor:
    """Scatter binned scores into target-conditioned histograms, the layout
    shared by the ``sketch`` and ``qsketch`` curve updates: binary ``bins (N,)``
    into ``counts (2, B)`` (row 0 the positives, ``target == pos_label``);
    ``bins (N, C)`` into ``(C, 2, B)``, one-vs-rest per class against int
    labels ``target (N,)`` or per column against ``target (N, C)``."""
    num_bins = counts.shape[-1]
    if bins.ndim == 1:
        if counts.ndim != 2:
            raise ValueError(
                f"{what} expects per-class input (N, {counts.shape[0]}); got 1-D predictions."
                f" Construct the metric without num_classes for binary {what} mode."
            )
        row = torch.where(target == pos_label, 0, 1)
        return scatter_count(counts, row * num_bins + bins, keep)
    if bins.ndim != 2 or counts.ndim != 3 or bins.shape[1] != counts.shape[0]:
        raise ValueError(
            f"{what}/state layout mismatch: preds {tuple(bins.shape)} vs counts {tuple(counts.shape)}."
            f" Multiclass/multilabel {what} mode needs num_classes at construction."
        )
    classes = torch.arange(bins.shape[1], device=bins.device)
    if target.ndim == 1:
        pos = target.unsqueeze(1) == classes.unsqueeze(0)
    else:
        pos = target == pos_label
    row = torch.where(pos, 0, 1)
    return scatter_count(counts, (classes * 2 + row) * num_bins + bins, keep)


def joint_histogram_scatter(counts: Tensor, bins_i: Tensor, bins_j: Tensor, keep: Tensor) -> Tensor:
    """Scatter ``(bins_i, bins_j)`` pairs into a ``(B, B)`` joint histogram."""
    return scatter_count(counts, bins_i * counts.shape[1] + bins_j, keep)


def qsketch_update(counts: Tensor, values: Tensor, alpha: float, min_value: float, max_value: float) -> Tensor:
    """Scatter one batch of raw values (any shape, raveled) into a ``(B,)``
    quantile sketch: the shared update of Quantile / Percentile. NaN values
    are dropped; ``±inf`` lands in the overflow buckets."""
    x, keep = _masked(torch.as_tensor(values).reshape(-1))
    return scatter_count(counts, qsketch_bucket(x, alpha, min_value, max_value), keep)


def qsketch_curve_update(counts: Tensor, preds: Tensor, target: Tensor, alpha: float, min_value: float,
                         max_value: float, pos_label: int) -> Tensor:
    """Scatter one batch into per-class positive / negative score histograms on
    the auto-ranged qsketch grid: the ``approx="qsketch"`` twin of
    ``sketch.sketch_curve_update`` (the same layouts). NaN predictions are
    dropped; ``±inf`` lands in the overflow buckets."""
    x, keep = _masked(preds)
    return curve_histogram_scatter(counts, qsketch_bucket(x, alpha, min_value, max_value), keep, target,
                                   pos_label, "qsketch")


def qsketch_rank_update(counts: Tensor, preds: Tensor, target: Tensor, alpha: float, min_value: float,
                        max_value: float) -> Tensor:
    """Scatter one batch of (preds, target) pairs into the joint histogram on
    the qsketch grid: the range-free ``approx="qsketch"`` rank update. Pairs
    with a NaN on either side are dropped."""
    p, keep_p = _masked(preds)
    t, keep_t = _masked(target)
    return joint_histogram_scatter(counts, qsketch_bucket(p, alpha, min_value, max_value),
                                   qsketch_bucket(t, alpha, min_value, max_value), keep_p & keep_t)


# ------------------------------------------------------------------- queries
def _rank_select(counts: Tensor, q: Any) -> Tuple[Tensor, Tensor]:
    """``(idx, n)``: the bucket each quantile's rank resolves to (the first
    whose cumulative count exceeds ``q * (n - 1)``) and the total count.

    The rank target is the JAX package's float32 product ``float32(q) *
    float32(n - 1)``; the cumulative counts are exact (int64, compared in
    float64) where the JAX package's float32 cumsum rounds past 2**24."""
    qs = tuple(float(v) for v in np.atleast_1d(np.asarray(q, dtype=np.float64)))
    qa = device_constant(("quantiles", qs), counts.device, lambda: qs, torch.float32)
    n = counts.sum(-1)
    cum = torch.cumsum(counts, -1).to(torch.float64)
    target = qa * torch.clamp(n - 1, min=0).to(torch.float32)
    idx = torch.searchsorted(cum, target.to(torch.float64), right=True).clamp(0, counts.shape[-1] - 1)
    return idx, n


def quantile_from_counts(counts: Tensor, q: Any, alpha: float, min_value: float, max_value: float) -> Tensor:
    """Float32 quantile estimates from a ``(B,)`` qsketch: the selected
    bucket's representative value, within relative error ``alpha`` (plus the
    ``min_value`` zero-bucket slack) wherever the rank resolves inside the
    certified span. ``q`` a scalar (a scalar result) or a sequence (a vector);
    ``nan`` on an empty sketch. No host read."""
    values = device_constant(("qsketch values", alpha, min_value, max_value), counts.device,
                             lambda: qsketch_bucket_values(alpha, min_value, max_value), torch.float32)
    idx, n = _rank_select(counts, q)
    out = torch.where(n > 0, values[idx], torch.nan)
    return out if np.ndim(q) else out[0]


def quantile_error_bound(counts: Tensor, q: Any, alpha: float, min_value: float, max_value: float) -> Tensor:
    """Certificate for :func:`quantile_from_counts`: relative bound ``alpha``
    per quantile where the rank resolves in a log or zero bucket
    (``|estimate - true| <= alpha * |true| + min_value``), ``inf`` where it
    resolves in an overflow bucket, ``nan`` on an empty sketch."""
    m, _ = _grid_params(alpha, min_value, max_value)
    idx, n = _rank_select(counts, q)
    overflow = (idx == 0) | (idx == 2 * m + 2)
    bound = torch.where(overflow, torch.inf, alpha).to(torch.float32)
    out = torch.where(n > 0, bound, torch.nan)
    return out if np.ndim(q) else out[0]


# ----------------------------------------------------- metric-side plumbing
def quantile_sketch_spec(
    alpha: float = QSKETCH_ALPHA,
    min_value: float = QSKETCH_MIN_VALUE,
    max_value: float = QSKETCH_MAX_VALUE,
    dtype: Any = None,
) -> QSketchSpec:
    """The spec a value-distribution metric registers (Quantile, Percentile,
    MedianAbsoluteError)."""
    shape = (qsketch_num_buckets(alpha, min_value, max_value),)
    return QSketchSpec("q", shape, dtype or accum_int_dtype(), float(alpha), float(min_value), float(max_value))


def qsketch_curve_spec(
    alpha: float = QSKETCH_CURVE_ALPHA,
    num_classes: Optional[int] = None,
    min_value: float = QSKETCH_CURVE_RANGE[0],
    max_value: float = QSKETCH_CURVE_RANGE[1],
    dtype: Any = None,
) -> QSketchSpec:
    """The spec a curve metric registers for ``approx="qsketch"``."""
    num_buckets = qsketch_num_buckets(alpha, min_value, max_value)
    shape = (2, num_buckets) if num_classes in (None, 1) else (num_classes, 2, num_buckets)
    return QSketchSpec("hist", shape, dtype or accum_int_dtype(), float(alpha), float(min_value), float(max_value))


def qsketch_rank_spec(
    alpha: float = QSKETCH_RANK_ALPHA,
    min_value: float = QSKETCH_RANK_RANGE[0],
    max_value: float = QSKETCH_RANK_RANGE[1],
    dtype: Any = None,
) -> QSketchSpec:
    """The spec a rank metric registers for ``approx="qsketch"``."""
    num_buckets = qsketch_num_buckets(alpha, min_value, max_value)
    if num_buckets > _MAX_RANK_GRID:
        raise ValueError(
            f"a rank qsketch keeps a (B, B) joint histogram; alpha={alpha!r} over"
            f" ({min_value!r}, {max_value!r}) needs B={num_buckets} > {_MAX_RANK_GRID}."
            " Rank statistics only consume the grid's ORDER — use a coarser alpha"
            " (the default 0.1 gives B=279) or a narrower magnitude span."
        )
    return QSketchSpec(
        "rank", (num_buckets, num_buckets), dtype or accum_int_dtype(),
        float(alpha), float(min_value), float(max_value),
    )


def _spec_key(tag: str, spec: QSketchSpec, metric: Any) -> tuple:
    # the device closes the key: members on different devices never share an update
    return (tag, spec.kind, spec.shape, str(spec.dtype), spec.alpha, spec.min_value, spec.max_value,
            str(metric.device))


def qsketch_value_group_key(metric: Any, state: str = "qsketch") -> tuple:
    """Compute-group key of a value-sketch metric: Quantile / Percentile
    instances with equal grid config run the same scatter (``q`` is
    compute-only), so one synced sketch serves every requested quantile."""
    return _spec_key("qsketch_q", metric._defaults[state], metric)


def qsketch_curve_group_key(metric: Any) -> tuple:
    """Compute-group key of a curve metric's qsketch update (shared across
    AUROC / AveragePrecision instances with equal config)."""
    pos_label = metric.pos_label if getattr(metric, "pos_label", None) is not None else 1
    return _spec_key("qsketch_curve", metric._defaults["hist"], metric) + (int(pos_label),)


def qsketch_rank_group_key(metric: Any) -> tuple:
    """Compute-group key of a rank metric's qsketch update (shared across
    Spearman / Kendall instances with equal config)."""
    return _spec_key("qsketch_rank", metric._defaults["joint"], metric)
