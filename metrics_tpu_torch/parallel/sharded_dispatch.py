"""Stateful-API dispatch to the sharded epoch engines.

Counterpart of ``metrics_tpu/parallel/sharded_dispatch.py``. When a cat-state
metric's ``PaddedBuffer`` states are row-sharded (``Metric.device_put`` with
:func:`~metrics_tpu_torch.parallel.placement.row_sharded`), ``compute()``
detects the placement here and runs the exact ring / ``all_to_all`` engine
of ``parallel/sharded_epoch.py`` over the placement's group instead of
gathering the epoch: sklearn-exact values with O(capacity / n) rows a rank,
and no user-written collective.

Detection reads the placement the metric remembers and the buffers' local
capacity (the JAX package reads the buffers' ``NamedSharding``). Each metric
family has an ``*_applicable`` predicate and a ``*_sharded`` runner; the
predicate is also what ``Metric._states_own_sync`` asks before it skips the
gather, so the two agree by construction. A batch value computed without a
sync (a ``forward`` without ``dist_sync_on_step``) is local by definition
and takes the single-rank path. Left out for good: the JAX package's jitted
``shard_map`` launch cache, which an eager port has no program to cache for.
Each engine call takes the place of the JAX package's ``_launch``: it runs in
a ``sharded.launch`` span (``{"key": engine}``, fenced in device-time mode,
the ``engine`` column of ``device_time_table``) and an
``annotate("sharded.engine")`` scope.

Every rank must reach the same runner: all ranks of the group update the
metric at least once an epoch (the buffers and the data mode come from the
first append), and the one host read of the counts follows an ``all_reduce``
of them, so an overflow or a lockstep fault on one rank raises on every rank
before any engine collective is entered.
"""
from typing import Any, Callable, NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch import Tensor

from metrics_tpu_torch.observability.counters import record_collective
from metrics_tpu_torch.observability.devtime import DEVTIME as _DEVTIME
from metrics_tpu_torch.observability.devtime import fence as _fence
from metrics_tpu_torch.observability.profiler import annotate
from metrics_tpu_torch.observability.trace import TRACE
from metrics_tpu_torch.observability.trace import span as _span
from metrics_tpu_torch.parallel.buffer import PaddedBuffer, buffer_mask, handle_overflow
from metrics_tpu_torch.parallel.placement import group_world
from metrics_tpu_torch.parallel.sharded_epoch import (
    _topo,
    sharded_auroc_matrix,
    sharded_average_precision_matrix,
    sharded_clf_curve_matrix,
    sharded_kendall,
    sharded_retrieval_sums,
    sharded_spearman,
)
from metrics_tpu_torch.utils.data import ClassScores
from metrics_tpu_torch.utils.enums import AverageMethod, DataType
from metrics_tpu_torch.utils.prints import rank_zero_warn_once


class ShardInfo(NamedTuple):
    """Where a metric's row-sharded epoch lives: the engine group (a process
    group, ``None`` for the default world, or a ``MeshHierarchy``) and its size."""

    group: Any
    world: int


def epoch_shard_info_of_state(metric: Any, name: str) -> Optional[ShardInfo]:
    """The shard info when state ``name`` of ``metric`` is a ``PaddedBuffer``
    kept row-sharded by a :func:`row_sharded` placement, else ``None``."""
    placement = getattr(metric, "_placement", None)
    if getattr(placement, "kind", None) != "row":
        return None
    value = getattr(metric, name, None)
    spec = metric._defaults.get(name)
    if not isinstance(value, PaddedBuffer) or spec is None:
        return None
    if placement.names is not None and name not in placement.names:
        return None
    world = group_world(placement.group)
    capacity = getattr(spec, "capacity", None)
    if capacity is None or capacity % world or value.capacity != capacity // world:
        return None
    return ShardInfo(placement.group, world)


def _shared_info(metric: Any, *names: str) -> Optional[ShardInfo]:
    """One shard info shared by all the named states, else ``None``. A
    compute without a sync (a step's local batch value) is never sharded."""
    if not getattr(metric, "_to_sync", True):
        return None
    infos = [epoch_shard_info_of_state(metric, n) for n in names]
    if not infos or any(i is None for i in infos) or any(i != infos[0] for i in infos):
        return None
    return infos[0]


def _check_counts(metric: Any, info: ShardInfo, *names: str) -> Tuple[Tensor, int]:
    """Epoch-end validation in one host read, agreed by every rank: one
    ``all_reduce`` (max) of this rank's largest count and its lockstep gap,
    then the read. A lockstep fault raises ``RuntimeError``, an overflow on
    any rank goes through ``handle_overflow`` (``BufferOverflowError`` under
    the default policy) on every rank. Returns the local validity mask of
    the first buffer's block and the largest count of any rank."""
    buffers = [getattr(metric, n) for n in names]
    counts = torch.stack([b.count for b in buffers])
    vec = torch.stack([counts.max(), counts.max() - counts.min()])
    if dist.is_available() and dist.is_initialized():
        topo = _topo(info.group)
        for level in (topo.ring, topo.dcn):
            if level is not None:
                record_collective("pmax", vec, crossing=level.crossing, fanout=level.n)
                dist.all_reduce(vec, op=dist.ReduceOp.MAX, group=level.group)
    largest, gap = vec.tolist()
    if gap:
        raise RuntimeError(
            f"{type(metric).__name__}: sharded cat-states disagree on row count (by {gap} rows on some rank);"
            " states must be appended in lockstep."
        )
    handle_overflow(names[0], largest, buffers[0].capacity)
    return buffer_mask(buffers[0]), largest


def _warn_gather_fallback(metric: Any, reason: str, *names: str) -> None:
    """Loud degradation notice: the epoch states ARE row-sharded but this
    configuration has no sharded engine, so ``compute()`` will gather the
    epoch, the O(dataset) cost the placement opted out of."""
    if _shared_info(metric, *names) is None:
        return
    rank_zero_warn_once(
        f"{type(metric).__name__}: row-sharded epoch states fall back to the"
        f" gathered compute path ({reason}); every device will materialize the"
        " full epoch."
    )


def owns_sync(metric: Any, plan: Any, reason: str, *names: str) -> bool:
    """``Metric._states_own_sync`` of a family with a dispatch ``plan``: a
    declined plan over row-sharded states warns of the gather before the
    compute wrapper gathers (once a message)."""
    if plan is None:
        _warn_gather_fallback(metric, reason, *names)
    return plan is not None


# --------------------------------------------------------------- AUROC / AP
_AUROC_FALLBACK = "no sharded engine for this mode/average configuration"
_AP_FALLBACK = "no sharded engine for this layout"

class _CurvePlan(NamedTuple):
    """A resolved dispatch plan for a curve scalar."""

    info: ShardInfo
    form: str  # 'binary' | 'binary-partial' | 'micro' | 'classes' | 'multilabel'


def _mode_of(metric: Any) -> Optional[Any]:
    """AUROC's data mode: the one its updates saw, else the buffers' layout."""
    if metric.mode is not None:
        return metric.mode
    p, t = metric.preds.data, metric.target.data
    if p.ndim == 1 or (p.ndim == 2 and p.shape[1] == 1 and t.ndim == 1):
        return DataType.BINARY
    return DataType.MULTILABEL if t.ndim == 2 else DataType.MULTICLASS


def auroc_applicable(metric: Any) -> Optional[_CurvePlan]:
    """The plan when ``AUROC.compute()`` runs sharded, else ``None``: binary
    (full and partial AUC via ``max_fpr``), multiclass (macro / weighted /
    none) and multilabel (micro / macro / weighted / none)."""
    if getattr(metric, "approx", None) is not None:
        return None
    info = _shared_info(metric, "preds", "target")
    if info is None:
        return None
    mode = _mode_of(metric)
    if metric.max_fpr is not None and metric.max_fpr != 1:
        if mode == DataType.BINARY:
            return _CurvePlan(info, "binary-partial")
        return None  # the gather path raises the max_fpr / mode error
    if mode == DataType.BINARY:
        return _CurvePlan(info, "binary")
    if mode == DataType.MULTILABEL and metric.average == AverageMethod.MICRO:
        return _CurvePlan(info, "micro")
    if metric.average in (AverageMethod.NONE, AverageMethod.MACRO, AverageMethod.WEIGHTED, None):
        return _CurvePlan(info, "classes")
    return None  # the gather path raises its exact average error


def average_precision_applicable(metric: Any) -> Optional[_CurvePlan]:
    """The plan when ``AveragePrecision.compute()`` runs sharded: binary,
    multiclass one-vs-rest and the multilabel layout."""
    if getattr(metric, "approx", None) is not None:
        return None
    info = _shared_info(metric, "preds", "target")
    if info is None or metric.num_classes is None:
        return None
    if metric.num_classes == 1:
        return _CurvePlan(info, "binary")
    p, t = metric.preds.data, metric.target.data
    if p.ndim == 2 and t.ndim == 1:
        return _CurvePlan(info, "classes")
    if p.ndim == 2 and t.ndim == 2:
        return _CurvePlan(info, "multilabel")
    return None


def _launch(key: str, engine: Callable, *args: Any, **kwargs: Any) -> Any:
    """Run one sharded engine call: the eager counterpart of the JAX package's
    ``_launch``, with its ``sharded.launch`` span and phase fence."""
    if TRACE.enabled:
        with _span("sharded.launch", {"key": key}):
            with annotate("sharded.engine"):
                out = engine(*args, **kwargs)
            if _DEVTIME.enabled:  # the engine's device time lands here
                _fence(out)
            return out
    return engine(*args, **kwargs)


def _class_scores(kind: str, info: ShardInfo, p: Tensor, t: Tensor, valid: Tensor, columns: str
                  ) -> Tuple[Tensor, Tensor]:
    """(C,) per-class scores and (C,) supports over the sharded epoch."""
    engine = sharded_auroc_matrix if kind == "auroc" else sharded_average_precision_matrix
    num_classes = p.shape[1]
    if columns == "labels":
        onehot = (t[:, None] == torch.arange(num_classes, device=t.device)).to(torch.int32)
    else:  # multilabel columns: positives are 1
        onehot = (t == 1).to(torch.int32)
    # the engine's per-class positive weight is the valid-row support: it rides the engine's own all_reduce
    return _launch(kind, engine, p, onehot, info.group, valid.to(torch.float32), with_support=True)


def _default_pos_label(metric: Any) -> int:
    """The gather path's binary ``pos_label`` default (a warning, then 1)."""
    if metric.pos_label is None:
        rank_zero_warn_once("`pos_label` automatically set 1.")
        return 1
    return metric.pos_label


def _binary_scalar(kind: str, info: ShardInfo, p: Tensor, t: Tensor, valid: Tensor, pos_label: int,
                   flatten: bool = False) -> Tensor:
    """An exact binary scalar over the sharded epoch (``flatten``: the micro
    average of a ``(rows, C)`` multilabel block)."""
    engine = sharded_auroc_matrix if kind == "auroc" else sharded_average_precision_matrix
    if not flatten and p.ndim > t.ndim:
        p = p[:, 0]  # the (rows, 1) binary layout
    y = (t == pos_label).to(torch.int32)
    w = valid.to(torch.float32)
    if flatten:
        w = w.repeat_interleave(p.shape[1])
        p, y = p.reshape(-1), y.reshape(-1)
    return _launch(kind, engine, p[:, None], y[:, None], info.group, w[:, None])[0]


def _average(scores: Tensor, support: Tensor, average: Any) -> Any:
    if average == AverageMethod.MACRO:
        return torch.mean(scores)
    if average == AverageMethod.WEIGHTED:
        return torch.sum(scores * support / torch.sum(support))
    return ClassScores(scores)


def auroc_sharded(metric: Any) -> Optional[Any]:
    """Row-sharded ``AUROC.compute()``: the exact ring when
    :func:`auroc_applicable`, else ``None`` (the caller gathers, loudly).
    Degenerate classes give ``nan`` (the static kernel's convention; the
    eager value checks would need the gathered epoch)."""
    plan = auroc_applicable(metric)
    if plan is None:
        _warn_gather_fallback(metric, _AUROC_FALLBACK, "preds", "target")
        return None
    valid, _ = _check_counts(metric, plan.info, "preds", "target")
    p, t = metric.preds.data, metric.target.data
    if plan.form == "binary-partial":
        from metrics_tpu_torch.functional.classification.curve_static import (
            partial_auroc_from_roc,
            roc_from_clf_curve,
        )

        pos_label = _default_pos_label(metric)
        p = p[:, 0] if p.ndim > t.ndim else p
        y = (t == pos_label).to(torch.float32)
        fps, tps, th, counts = _launch("clf_curve", sharded_clf_curve_matrix, p[None, :], y[None, :],
                                       valid.to(torch.float32)[None, :], plan.info.group)
        fpr, tpr, _, _ = roc_from_clf_curve(fps[0], tps[0], th[0], counts[0])
        return partial_auroc_from_roc(fpr, tpr, float(metric.max_fpr))
    if plan.form in ("binary", "micro"):
        return _binary_scalar("auroc", plan.info, p, t, valid, _default_pos_label(metric),
                              flatten=plan.form == "micro")
    columns = "multilabel" if _mode_of(metric) == DataType.MULTILABEL else "labels"
    if columns == "labels" and metric.pos_label is not None:
        rank_zero_warn_once(
            f"Argument `pos_label` should be `None` when running multiclass AUROC. Got {metric.pos_label}"
        )
    scores, support = _class_scores("auroc", plan.info, p, t, valid, columns)
    return _average(scores, support, metric.average)


def average_precision_sharded(metric: Any) -> Optional[Any]:
    """Row-sharded ``AveragePrecision.compute()``; ``None``: the gather path."""
    plan = average_precision_applicable(metric)
    if plan is None:
        _warn_gather_fallback(metric, _AP_FALLBACK, "preds", "target")
        return None
    valid, _ = _check_counts(metric, plan.info, "preds", "target")
    p, t = metric.preds.data, metric.target.data
    if plan.form == "binary":
        return _binary_scalar("ap", plan.info, p, t, valid, _default_pos_label(metric))
    scores, _ = _class_scores("ap", plan.info, p, t, valid, "multilabel" if plan.form == "multilabel" else "labels")
    return ClassScores(scores)


# ------------------------------------------------------------- curve vectors
def curve_applicable(metric: Any) -> Optional[ShardInfo]:
    """The shard info when ``ROC`` / ``PrecisionRecallCurve`` compute their
    padded curve vectors over row-sharded states, else ``None``."""
    if getattr(metric, "approx", None) is not None:
        return None
    return _shared_info(metric, "preds", "target")


def curve_sharded(metric: Any, kind: str) -> Optional[tuple]:
    """Row-sharded curve vectors for ``ROC`` (``kind="roc"``) /
    ``PrecisionRecallCurve`` (``kind="prc"``); ``None``: the padded path.

    The output contract of ``padded_curve_compute`` (global-capacity curves,
    the distinct points at the front, and valid counts; a class axis for 2-D
    preds), replicated on every rank: the counting runs on the ring, and only
    the finished points are gathered."""
    from metrics_tpu_torch.functional.classification.curve_static import (
        precision_recall_from_clf_curve,
        roc_from_clf_curve,
    )

    info = curve_applicable(metric)
    if info is None:
        return None
    valid = _check_counts(metric, info, "preds", "target")[0].to(torch.float32)
    p, t = metric.preds.data, metric.target.data
    if p.ndim == 1:
        pos_label = _default_pos_label(metric)
        p_cm, y_cm, w_cm = p[None, :], (t == pos_label).to(torch.float32)[None, :], valid[None, :]
    elif t.ndim == 2:  # multilabel: column c against positives == 1
        p_cm, y_cm, w_cm = p.T, (t == 1).T.to(torch.float32), valid[None, :].expand(p.shape[1], -1)
    else:  # multiclass: class c against the rest
        classes = torch.arange(p.shape[1], device=t.device)[:, None]
        p_cm, y_cm, w_cm = p.T, (t[None, :] == classes).to(torch.float32), valid[None, :].expand(p.shape[1], -1)
    fps, tps, th, counts = _launch("clf_curve", sharded_clf_curve_matrix, p_cm, y_cm, w_cm, info.group)
    transform = roc_from_clf_curve if kind == "roc" else precision_recall_from_clf_curve
    outs = [transform(fps[c], tps[c], th[c], counts[c]) for c in range(fps.shape[0])]
    if p.ndim == 1:
        return outs[0]
    return tuple(torch.stack(parts) for parts in zip(*outs))


# ----------------------------------------------------------- rank correlation
def rank_corr_applicable(metric: Any) -> Optional[ShardInfo]:
    """The shard info when Spearman / Kendall compute over row-sharded states."""
    if getattr(metric, "approx", None) is not None:
        return None
    return _shared_info(metric, "preds_all", "target_all")


def _rank_corr_sharded(metric: Any, kind: str) -> Optional[Tensor]:
    """The ring's rank statistics over the sharded epoch (Spearman: global
    midranks and a summed Pearson; Kendall: the O(N^2) contraction split over
    the ring). An empty epoch gives ``nan``, the gather path's convention."""
    info = rank_corr_applicable(metric)
    if info is None:
        return None
    valid, largest = _check_counts(metric, info, "preds_all", "target_all")
    valid = valid.to(torch.float32)
    p, t = metric.preds_all.data, metric.target_all.data
    if kind == "kendall":
        from metrics_tpu_torch.functional.regression.kendall import _warn_if_quadratic

        # the ring splits the quadratic work n ways, but its total stays quadratic: the same warning,
        # at the epoch's rows when the ranks hold equal shares
        _warn_if_quadratic(largest * info.world)
        return _launch("kendall", sharded_kendall, p, t, info.group, valid)
    return _launch("spearman", sharded_spearman, p, t, info.group, valid)


def spearman_sharded(metric: Any) -> Optional[Tensor]:
    """Row-sharded ``SpearmanCorrcoef.compute()``; ``None``: the gather path."""
    return _rank_corr_sharded(metric, "spearman")


def kendall_sharded(metric: Any) -> Optional[Tensor]:
    """Row-sharded ``KendallRankCorrCoef.compute()``; ``None``: the gather path."""
    return _rank_corr_sharded(metric, "kendall")


# ---------------------------------------------------------------- retrieval
def retrieval_applicable(metric: Any) -> Optional[ShardInfo]:
    """The shard info when ``RetrievalMetric.compute()`` runs sharded."""
    return _shared_info(metric, "idx", "preds", "target")


def default_regroup_capacity(local_rows: int, world: int) -> int:
    """Four times the balanced load of a destination bucket, at least 8 (the
    JAX package's default), but never more than the rank's rows: a rank
    cannot send one destination more rows than it holds, so a larger bucket
    is padding that the regrouped scoring would pay for (4x on one rank)."""
    return min(max(4 * -(-local_rows // world), 8), max(local_rows, 1))


def retrieval_sharded(metric: Any) -> Optional[Tensor]:
    """Row-sharded ``RetrievalMetric.compute()``: the ``all_to_all`` regroup
    and the grouped engine; ``None``: the gather path.

    A bucket overflow (skewed query ids) raises with the knob to turn,
    ``metric.regroup_capacity``; the ``'error'`` policy reads the globally
    reduced flag. Both come back in one host read."""
    info = retrieval_applicable(metric)
    if info is None:
        return None
    valid, _ = _check_counts(metric, info, "idx", "preds", "target")
    capacity = metric.regroup_capacity
    if capacity is None:
        capacity = default_regroup_capacity(metric.idx.capacity, info.world)
    mean, flag, dropped = _launch("retrieval", sharded_retrieval_sums, metric, metric.idx.data, metric.preds.data,
                                  metric.target.data, info.group, capacity=capacity, valid=valid)
    n_dropped, empty = torch.stack([dropped.to(torch.int64), flag.to(torch.int64)]).tolist()
    if n_dropped:
        raise RuntimeError(
            f"{type(metric).__name__}: {n_dropped} rows overflowed the sharded regroup's"
            " per-destination buckets (skewed query-id distribution). Set"
            " `metric.regroup_capacity` to a larger per-shard bucket capacity."
        )
    if metric.query_without_relevant_docs == "error" and empty:
        raise ValueError(f"`{type(metric).__name__}.compute()` was provided with a query {metric._EMPTY_QUERY_ERROR}")
    return mean
