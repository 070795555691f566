"""Capacity-backed curve compute for ``ROC`` / ``PrecisionRecallCurve``.

Counterpart of ``metrics_tpu/classification/_padded_curves.py``. When the
epoch states are PaddedBuffers (a metric built with ``capacity``), compute runs
the static-shape padded kernels of ``functional/classification/curve_static.py``:
capacity-length curves plus a valid count, with no data-dependent shape. The
only host read is the row-count check. Row-sharded states
(``parallel.placement.row_sharded``) take the ring and the key-sort of
``parallel/sharded_dispatch.curve_sharded`` instead, with the same output.
"""
from typing import Any, Optional

import torch

from metrics_tpu_torch.functional.classification.curve_static import precision_recall_curve_padded, roc_padded
from metrics_tpu_torch.parallel.buffer import PaddedBuffer, buffer_mask

_KERNELS = {"roc": roc_padded, "prc": precision_recall_curve_padded}


def _check_counts(metric: Any, *buffers: PaddedBuffer) -> int:
    """Epoch-end validation in one host read: the buffers were appended in
    lockstep and none overflowed."""
    counts = torch.stack([b.count for b in buffers]).tolist()
    if any(c != counts[0] for c in counts):
        raise RuntimeError(
            f"{type(metric).__name__}: sharded cat-states disagree on row count {counts};"
            " states must be appended in lockstep."
        )
    if counts[0] > buffers[0].capacity:
        raise RuntimeError(
            f"PaddedBuffer overflow: {counts[0]} rows appended into capacity "
            f"{buffers[0].capacity}. Increase the metric's `capacity` argument."
        )
    return counts[0]


def padded_curve_compute(metric: Any, kind: str) -> Optional[tuple]:
    """Static-shape curve compute when the epoch states are PaddedBuffers;
    ``None`` sends the caller down the dynamic path."""
    if not isinstance(metric.preds, PaddedBuffer):
        return None
    from metrics_tpu_torch.parallel.sharded_dispatch import curve_sharded

    sharded = curve_sharded(metric, kind)  # row-sharded states: the ring and a key-sort
    if sharded is not None:
        return sharded
    _check_counts(metric, metric.preds, metric.target)
    pos_label = metric.pos_label if metric.pos_label is not None else 1
    return _KERNELS[kind](
        metric.preds.data, metric.target.data, None, pos_label=int(pos_label), row_mask=buffer_mask(metric.preds)
    )
