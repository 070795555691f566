"""Mergeable sketch states: constant-memory curve and rank metrics.

Counterpart of ``metrics_tpu/parallel/sketch.py``. The curve and rank metrics
keep every prediction in their exact mode; their ``approx="sketch"`` mode keeps
a fixed-grid histogram instead, whose size does not grow with the traffic:

- :class:`HistogramSketch`: per-class score histograms conditioned on the
  target, counts ``(2, B)`` (binary: row 0 the positives, row 1 the negatives)
  or ``(C, 2, B)``. Thresholded TP / FP / TN / FN on the ``B + 1`` threshold
  grid (the ``B`` bin lower edges and a terminal all-rejecting threshold) are
  exact for the binned data, so ROC / PR / AUROC / AP derive at ``compute()``
  with an error bounded by the in-bin collision mass
  (:func:`auroc_error_bound`).
- :class:`RankSketch`: a ``(B, B)`` joint histogram. Spearman is the
  midrank Pearson correlation over the joint counts and Kendall's tau-b comes
  from 2-D suffix sums: scipy's tie-averaged statistics of the binned data.

The update is one ``scatter_add`` of ones into a flat view (row-major flat
index): exact integer atomics on the card, so its counts equal the CPU's bit
for bit; it never reads the host. Merge is elementwise integer addition and
the sync rides the int64 sum bucket of ``parallel/sync.py``. Counts are int64
(``accum_int_dtype``), where the JAX package keeps int32 without x64.

The linear grid (:func:`score_to_bin`) and the soft-sign rank grid
(:func:`rank_to_bin`) are the JAX package's float32 formulas, op for op, so
their bins equal the JAX package's bit for bit. The curve and rank math takes
the int64 counts into float64 and returns float32: the JAX package's float32
copy of the counts is exact only to 2**24 samples, and its Spearman
denominator ``sqrt(var_x * var_y)`` overflows float32 from about 6 million
samples (ROADMAP section 3).
"""
from typing import Any, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch
from torch import Tensor

from metrics_tpu_torch.parallel.cms import CountMinSketch
from metrics_tpu_torch.parallel.qsketch import QuantileSketch, curve_histogram_scatter, joint_histogram_scatter
from metrics_tpu_torch.utils.data import accum_int_dtype

__all__ = [
    "HistogramSketch",
    "RankSketch",
    "SketchSpec",
    "auroc_error_bound",
    "auroc_from_histogram",
    "average_precision_from_histogram",
    "canonicalize_approx",
    "curve_collision_bound",
    "curve_counts_from_histogram",
    "curve_sketch_group_key",
    "curve_sketch_spec",
    "is_sketch",
    "kendall_from_joint",
    "precision_recall_from_histogram",
    "rank_collision_bound",
    "rank_sketch_group_key",
    "rank_sketch_spec",
    "rank_to_bin",
    "roc_from_histogram",
    "score_to_bin",
    "sketch_curve_update",
    "sketch_init",
    "sketch_merge",
    "sketch_nbytes",
    "sketch_rank_update",
    "sketch_thresholds",
    "spearman_from_joint",
]


class HistogramSketch(NamedTuple):
    """Fixed-grid score histogram conditioned on the target: ``(2, B)`` integer
    counts (row 0 the positives, row 1 the negatives) or ``(C, 2, B)``."""

    counts: Tensor


class RankSketch(NamedTuple):
    """``(B, B)`` joint histogram over (preds bin, target bin)."""

    counts: Tensor


# the count-min and quantile kinds are one more counts-backed sum-mergeable
# state each: every counts-based arm (sync, merge, checkpoint) takes them too
_SKETCH_TYPES = (HistogramSketch, RankSketch, CountMinSketch, QuantileSketch)
_KINDS = {"hist": HistogramSketch, "rank": RankSketch, "cms": CountMinSketch, "qsketch": QuantileSketch}


def is_sketch(value: Any) -> bool:
    """Whether ``value`` is a sketch state (histogram, rank, count-min or
    quantile): one integer counts tensor, merge = add, sync = the sum bucket."""
    return isinstance(value, _SKETCH_TYPES)


class SketchSpec(NamedTuple):
    """Sketch state declaration (what ``Metric.add_state`` records).

    ``kind``: ``"hist"`` or ``"rank"``. ``shape`` / ``dtype``: the counts.
    ``lo`` / ``hi``: the range of the linear grid; ``None`` / ``None`` (rank
    sketches only) selects the range-free soft-sign grid of
    :func:`rank_to_bin`. Pure config, fingerprintable.
    """

    kind: str
    shape: Tuple[int, ...]
    dtype: Any
    lo: Optional[float]
    hi: Optional[float]


def sketch_init(spec: SketchSpec, device: Optional[Union[str, torch.device]] = None):
    """Fresh zero-count sketch for ``spec`` on ``device``."""
    return _KINDS[spec.kind](torch.zeros(spec.shape, dtype=spec.dtype, device=device))


def sketch_merge(a, b):
    """Pairwise sketch merge: elementwise integer addition, bit-exact."""
    if type(a) is not type(b):
        raise TypeError(f"cannot merge sketch kinds {type(a).__name__} and {type(b).__name__}")
    return type(a)(a.counts + b.counts)


def sketch_nbytes(value) -> int:
    """State bytes of one sketch (traffic-independent)."""
    return value.counts.numel() * value.counts.element_size()


# ------------------------------------------------------------------- binning
def score_to_bin(x: Tensor, num_bins: int, lo: float, hi: float) -> Tensor:
    """Int64 linear bin of ``x`` on the ``[lo, hi)`` grid, clipped into the end
    bins (``±inf`` included): the JAX package's float32 ``floor((x - lo) *
    (B / (hi - lo)))``. NaN has no bin: callers mask it first."""
    scaled = (x - lo) * (num_bins / (hi - lo))
    return torch.clamp(torch.floor(scaled), 0, num_bins - 1).to(torch.int64)


def rank_to_bin(x: Tensor, num_bins: int, lo: Optional[float], hi: Optional[float]) -> Tensor:
    """Bin of ``x`` for rank sketches: the linear grid with an explicit ``(lo,
    hi)``; with ``lo is None``, the value is squashed through the strictly
    increasing soft-sign map ``1/2 + x / (2 (1 + |x|))`` into ``(0, 1)`` first
    (``±inf`` to the sign limit) and binned there. Rank statistics are
    invariant under it, so the squash changes only which values collide."""
    if lo is None:
        t = torch.where(torch.isinf(x), torch.sign(x), x / (1.0 + torch.abs(x)))
        return score_to_bin(0.5 + 0.5 * t, num_bins, 0.0, 1.0)
    return score_to_bin(x, num_bins, lo, hi)


def sketch_thresholds(num_bins: int, lo: float, hi: float) -> np.ndarray:
    """The ``B + 1`` float32 thresholds curve sketches report: the ``B`` bin
    lower edges plus ``hi``, the terminal threshold that rejects every
    sample. Host numpy (grid config)."""
    return (lo + np.arange(num_bins + 1, dtype=np.float64) * ((hi - lo) / num_bins)).astype(np.float32)


def _masked_nan(x: Tensor, fill: float) -> Tuple[Tensor, Tensor]:
    """``(x with NaN replaced by fill, keep flags)``."""
    nan = torch.isnan(x)
    return torch.where(nan, fill, x), ~nan


# ------------------------------------------------------------------- updates
def sketch_curve_update(counts: Tensor, preds: Tensor, target: Tensor, lo: float, hi: float,
                        pos_label: int) -> Tensor:
    """Scatter one batch into per-class positive / negative score histograms:
    the shared update of every curve metric's sketch mode, so equal-config
    AUROC / ROC / PrecisionRecallCurve / AveragePrecision members form one
    compute group. Layouts: binary ``preds (N,)`` into ``(2, B)``; ``preds (N,
    C)`` with int labels ``(N,)`` (multiclass) or ``target (N, C)``
    (multilabel) into ``(C, 2, B)``. NaN predictions are dropped (a zero
    increment); ``±inf`` clips into the end bins."""
    x, keep = _masked_nan(preds, lo)
    return curve_histogram_scatter(counts, score_to_bin(x, counts.shape[-1], lo, hi), keep, target, pos_label,
                                   "sketch")


def sketch_rank_update(counts: Tensor, preds: Tensor, target: Tensor, lo: Optional[float],
                       hi: Optional[float]) -> Tensor:
    """Scatter one batch of (preds, target) pairs into the joint histogram: the
    shared update of Spearman's and Kendall's sketch mode. Pairs with a NaN on
    either side are dropped; ``±inf`` lands in the end bins."""
    p, keep_p = _masked_nan(preds, 0.0)
    t, keep_t = _masked_nan(target, 0.0)
    return joint_histogram_scatter(counts, rank_to_bin(p, counts.shape[0], lo, hi),
                                   rank_to_bin(t, counts.shape[1], lo, hi), keep_p & keep_t)


# ---------------------------------------------------------------- curve math
def _rev_cumsum(x: Tensor) -> Tensor:
    return torch.flip(torch.cumsum(torch.flip(x, (-1,)), -1), (-1,))


def _curve_counts64(counts: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    h = counts.to(torch.float64)
    pos, neg = h[..., 0, :], h[..., 1, :]
    zero = torch.zeros_like(pos[..., :1])
    tp = torch.cat([_rev_cumsum(pos), zero], -1)
    fp = torch.cat([_rev_cumsum(neg), zero], -1)
    return tp, fp, pos.sum(-1, keepdim=True) - tp, neg.sum(-1, keepdim=True) - fp


def curve_counts_from_histogram(counts: Tensor) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Float32 ``(tp, fp, tn, fn)`` on the ``B + 1`` threshold grid from
    ``(..., 2, B)`` counts: suffix sums (samples at or above each bin edge)
    plus a trailing zero column for the terminal threshold, which anchors the
    curves at (0, 0). Exact for the binned data (in float64 before the final
    rounding). Shapes ``(..., B + 1)``."""
    tp, fp, fn, tn = _curve_counts64(counts)
    return tp.float(), fp.float(), tn.float(), fn.float()


def _roc64(counts: Tensor) -> Tuple[Tensor, Tensor]:
    tp, fp, fn, tn = _curve_counts64(counts)
    return fp / torch.clamp(fp + tn, min=1.0), tp / torch.clamp(tp + fn, min=1.0)


def roc_from_histogram(counts: Tensor) -> Tuple[Tensor, Tensor]:
    """Float32 (fpr, tpr) on the ascending ``B + 1`` threshold grid, ending at
    the (0, 0) terminal point."""
    fpr, tpr = _roc64(counts)
    return fpr.float(), tpr.float()


def auroc_from_histogram(counts: Tensor) -> Tensor:
    """AUROC by the trapezoidal rule over the sketched ROC (float32): the grid
    points lie on the empirical ROC, so the only error is the within-bin
    interpolation (:func:`auroc_error_bound`)."""
    fpr, tpr = _roc64(counts)
    return (-torch.trapezoid(tpr, fpr, dim=-1)).float()


def _collision64(counts: Tensor) -> Tensor:
    h = counts.to(torch.float64)
    pos, neg = h[..., 0, :], h[..., 1, :]
    p_total = torch.clamp(pos.sum(-1), min=1.0)
    n_total = torch.clamp(neg.sum(-1), min=1.0)
    return (pos * neg).sum(-1) / (p_total * n_total)


def auroc_error_bound(counts: Tensor) -> Tensor:
    """Certificate ``|sketch AUROC - exact AUROC| <= bound`` (float32): the
    trapezoid gives every same-bin positive / negative pair half credit, so the
    error is at most half the in-bin collision mass ``sum_b pos_b neg_b / (2 P
    N)``. Per class for the ``(C, 2, B)`` layout."""
    return (_collision64(counts) / 2.0).float()


def curve_collision_bound(counts: Tensor) -> Tensor:
    """The fraction of positive / negative cross pairs colliding in one bucket,
    ``sum_b pos_b neg_b / (P N)`` (float32): the mass whose order the grid
    cannot resolve, twice :func:`auroc_error_bound`. Any monotone grid."""
    return _collision64(counts).float()


def rank_collision_bound(counts: Tensor) -> Tensor:
    """The fraction of sample pairs colliding in one grid bucket on either
    variable of a joint rank histogram, ``sum_i p_i (p_i - 1) / (n (n - 1))``
    per marginal, summed (float32). The only pairs the binned statistics
    resolve as ties instead of exactly."""
    h = counts.to(torch.float64)
    n = h.sum()
    p, t = h.sum(1), h.sum(0)
    pairs = torch.clamp(n * (n - 1.0), min=1.0)
    return ((torch.sum(p * (p - 1.0)) + torch.sum(t * (t - 1.0))) / pairs).float()


def _precision_recall64(counts: Tensor) -> Tuple[Tensor, Tensor]:
    tp, fp, fn, _ = _curve_counts64(counts)
    denom_p, denom_r = tp + fp, tp + fn
    precision = torch.where(denom_p == 0, 0.0, tp / torch.where(denom_p == 0, 1.0, denom_p))
    precision[..., -1].fill_(1.0)  # fill_, not a setitem: that copies a host scalar (a synchronizing call)
    recall = torch.where(denom_r == 0, 0.0, tp / torch.where(denom_r == 0, 1.0, denom_r))
    return precision, recall


def precision_recall_from_histogram(counts: Tensor) -> Tuple[Tensor, Tensor]:
    """Float32 (precision, recall) on the ascending ``B + 1`` grid (0 where
    undefined), the terminal point taking the exact module's (precision = 1,
    recall = 0) endpoint."""
    precision, recall = _precision_recall64(counts)
    return precision.float(), recall.float()


def average_precision_from_histogram(counts: Tensor) -> Tensor:
    """Average precision as the step integral over the sketched PR curve
    (float32); the terminal point supplies the final recall step."""
    precision, recall = _precision_recall64(counts)
    return (-torch.sum((recall[..., 1:] - recall[..., :-1]) * precision[..., :-1], dim=-1)).float()


# ----------------------------------------------------------------- rank math
def _midranks(marginal: Tensor) -> Tensor:
    """1-based mid ranks of each bin's occupants: a bin of ``m`` tied values at
    ranks ``c + 1 .. c + m`` gets ``c + (m + 1) / 2``."""
    return torch.cumsum(marginal, 0) - marginal / 2.0 + 0.5


def spearman_from_joint(counts: Tensor) -> Tensor:
    """Spearman rank correlation from the joint histogram (float32): the
    counts-weighted Pearson correlation of the bins' midranks, exactly scipy's
    tie-averaged Spearman of the binned data; ``nan`` on degenerate input.
    The denominator is ``sqrt(var_x) * sqrt(var_y)`` in float64."""
    h = counts.to(torch.float64)
    n = h.sum()
    p, t = h.sum(1), h.sum(0)
    r = _midranks(p) - (n + 1.0) / 2.0
    s = _midranks(t) - (n + 1.0) / 2.0
    cov = torch.sum(h * r[:, None] * s[None, :])
    denom = torch.sqrt(torch.clamp(torch.sum(p * r * r), min=0.0)) * torch.sqrt(torch.clamp(torch.sum(t * s * s),
                                                                                               min=0.0))
    return torch.where(denom == 0, torch.nan, cov / torch.where(denom == 0, 1.0, denom)).float()


def kendall_from_joint(counts: Tensor) -> Tensor:
    """Kendall's tau-b from the joint histogram (float32): concordant and
    discordant pair totals from 2-D suffix sums (pairs in distinct bins resolve
    exactly, same-bin pairs are ties), tie terms from the marginals; exactly
    ``scipy.stats.kendalltau`` of the binned data, ``nan`` on degenerate
    input."""
    h = counts.to(torch.float64)
    n = h.sum()
    suf = torch.flip(torch.cumsum(torch.cumsum(torch.flip(h, (0, 1)), 0), 1), (0, 1))
    s_gt = torch.zeros_like(h)
    s_gt[:-1, :-1] = suf[1:, 1:]  # i' > i and j' > j
    row_suf = torch.zeros_like(h)
    row_suf[:-1, :] = torch.flip(torch.cumsum(torch.flip(h, (0,)), 0), (0,))[1:, :]
    s_lt = torch.zeros_like(h)
    s_lt[:, 1:] = torch.cumsum(row_suf, 1)[:, :-1]  # i' > i and j' < j
    concordant, discordant = torch.sum(h * s_gt), torch.sum(h * s_lt)
    p, t = h.sum(1), h.sum(0)
    n0 = n * (n - 1.0) / 2.0
    n1 = torch.sum(p * (p - 1.0)) / 2.0
    n2 = torch.sum(t * (t - 1.0)) / 2.0
    denom = torch.sqrt(torch.clamp(n0 - n1, min=0.0) * torch.clamp(n0 - n2, min=0.0))
    return torch.where(denom > 0, (concordant - discordant) / torch.where(denom > 0, denom, 1.0), torch.nan).float()


# ----------------------------------------------------- metric-side plumbing
def curve_sketch_spec(num_bins: int, num_classes: Optional[int], lo: float, hi: float,
                      dtype: Any = None) -> SketchSpec:
    """The spec a curve metric registers for ``approx="sketch"``."""
    if not isinstance(num_bins, int) or num_bins < 2:
        raise ValueError(f"`num_bins` must be an int >= 2, got {num_bins!r}")
    if not (hi > lo):
        raise ValueError(f"sketch range must satisfy lo < hi, got ({lo}, {hi})")
    shape = (2, num_bins) if num_classes in (None, 1) else (num_classes, 2, num_bins)
    return SketchSpec("hist", shape, dtype or accum_int_dtype(), float(lo), float(hi))


def rank_sketch_spec(num_bins: int, lo: Optional[float], hi: Optional[float], dtype: Any = None) -> SketchSpec:
    """The spec a rank metric registers for ``approx="sketch"`` (``lo=None``:
    the range-free soft-sign grid)."""
    if not isinstance(num_bins, int) or num_bins < 2:
        raise ValueError(f"`num_bins` must be an int >= 2, got {num_bins!r}")
    if (lo is None) != (hi is None):
        raise ValueError("sketch_range must be None or a (lo, hi) pair")
    if lo is not None and not (hi > lo):
        raise ValueError(f"sketch range must satisfy lo < hi, got ({lo}, {hi})")
    return SketchSpec(
        "rank", (num_bins, num_bins), dtype or accum_int_dtype(),
        None if lo is None else float(lo), None if hi is None else float(hi),
    )


def canonicalize_approx(approx: Optional[str], allowed: Tuple[str, ...] = ("sketch",)) -> Optional[str]:
    """Validate an ``approx=`` constructor argument (None: the exact mode)."""
    if approx is not None and approx not in allowed:
        raise ValueError(f"`approx` must be None or one of {allowed}, got {approx!r}")
    return approx


def curve_sketch_group_key(metric: Any) -> tuple:
    """Compute-group key of a curve metric's sketch update: AUROC / ROC /
    PrecisionRecallCurve / AveragePrecision instances with equal keys run the
    same :func:`sketch_curve_update` over the same ``hist`` state on the same
    device, so one scatter serves them all; each keeps its own compute."""
    spec = metric._defaults["hist"]
    pos_label = metric.pos_label if getattr(metric, "pos_label", None) is not None else 1
    return ("sketch_curve", spec.shape, str(spec.dtype), spec.lo, spec.hi, int(pos_label), str(metric.device))


def rank_sketch_group_key(metric: Any) -> tuple:
    """Compute-group key of a rank metric's sketch update (shared across
    Spearman / Kendall instances with equal config)."""
    spec = metric._defaults["joint"]
    return ("sketch_rank", spec.shape, str(spec.dtype), spec.lo, spec.hi, str(metric.device))
