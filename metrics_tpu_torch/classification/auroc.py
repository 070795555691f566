"""AUROC module: area under the ROC curve over every prediction seen, exact or sketched.

Counterpart of ``metrics_tpu/classification/auroc.py``.
"""
from typing import Any, Callable, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.classification._curve_base import _CurveMetric
from metrics_tpu_torch.functional.classification.auroc import _auroc_compute, _auroc_update
from metrics_tpu_torch.observability.trace import TRACE
from metrics_tpu_torch.observability.trace import span as _span
from metrics_tpu_torch.parallel.buffer import as_values
from metrics_tpu_torch.parallel.qsketch import QSKETCH_CURVE_ALPHA
from metrics_tpu_torch.parallel.sketch import auroc_error_bound, auroc_from_histogram
from metrics_tpu_torch.utils.checks import _input_format_classification


class AUROC(_CurveMetric):
    """Area under the ROC curve, over all data seen.

    ``approx="sketch"`` replaces the prediction states with a constant-memory
    histogram sketch of ``num_bins`` score bins per class over
    ``sketch_range``: the update is one scatter, the sync one ``all_reduce``,
    and ``compute`` takes the AUROC from the sketched ROC with an error bounded
    by the in-bin collision mass (:meth:`error_bound`). ``approx="qsketch"``
    bins raw scores on the log-bucketed grid of relative accuracy ``alpha``,
    with no ``sketch_range`` to choose. Multiclass / multilabel sketch modes
    need ``num_classes`` at construction; ``max_fpr`` needs the exact mode.

    Example (binary):
        >>> import torch
        >>> preds = torch.tensor([0.13, 0.26, 0.08, 0.19, 0.34])
        >>> target = torch.tensor([0, 0, 1, 1, 1])
        >>> auroc = AUROC(pos_label=1, device="cpu")
        >>> float(auroc(preds, target))
        0.5
    """

    _APPROX_MODES = ("sketch", "qsketch")
    _EXACT_WARNING = (
        "Metric `AUROC` stores every prediction and target in an O(samples)"
        " buffer state, so memory and sync traffic grow with the dataset."
        " Construct with `approx=\"qsketch\"` for a constant-memory"
        " AUTO-RANGED histogram sketch (no sketch_range assumption on raw"
        " logits) that syncs with one all_reduce, `approx=\"sketch\"` for the"
        " fixed-grid variant, or use `BinnedAUROC`; exact buffers remain"
        " the default."
    )

    def __init__(
        self,
        num_classes: Optional[int] = None,
        pos_label: Optional[int] = None,
        average: Optional[str] = "macro",
        max_fpr: Optional[float] = None,
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        capacity: Optional[int] = None,
        approx: Optional[str] = None,
        num_bins: int = 2048,
        sketch_range: Tuple[float, float] = (0.0, 1.0),
        alpha: float = QSKETCH_CURVE_ALPHA,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(num_classes, pos_label, compute_on_step, dist_sync_on_step, process_group, dist_sync_fn,
                         capacity, device, approx, num_bins, sketch_range, alpha)
        self.average = average
        self.max_fpr = max_fpr

        allowed_average = (None, "macro", "weighted", "micro")
        if self.average not in allowed_average:
            raise ValueError(
                f"Argument `average` expected to be one of the following: {allowed_average} but got {average}"
            )
        if self.max_fpr is not None:
            if not isinstance(max_fpr, float) or not 0 < max_fpr <= 1:
                raise ValueError(f"`max_fpr` should be a float in range (0, 1], got: {max_fpr}")
        self.mode = None
        if self.approx is not None and self.max_fpr is not None:
            raise ValueError(
                f"`max_fpr` (partial AUC) is not supported with approx={self.approx!r};"
                " use the exact buffer mode."
            )
        self._add_states()

    def update(self, preds: Tensor, target: Tensor) -> None:
        if self.approx is not None:
            self._sketch_update(preds, target)
            return
        preds, target, mode = _auroc_update(preds, target)
        self._append("preds", preds)
        self._append("target", target)
        if self.mode is not None and self.mode != mode:
            raise ValueError(
                "The mode of data (binary, multi-label, multi-class) should be constant, but changed"
                f" between batches from {self.mode} to {mode}"
            )
        self.mode = mode

    def _sketch_compute(self) -> Tensor:
        counts = self.hist.counts
        if counts.ndim == 2:
            return auroc_from_histogram(counts)
        if self.average == "micro":
            return auroc_from_histogram(torch.sum(counts, dim=0))
        per_class = auroc_from_histogram(counts)  # (C,)
        if self.average == "macro":
            return torch.mean(per_class)
        if self.average == "weighted":
            support = torch.sum(counts[:, 0, :], dim=-1).to(torch.float32)
            return torch.sum(per_class * support / torch.clamp(torch.sum(support), min=1.0))
        return per_class

    def error_bound(self) -> Tensor:
        """Certificate of the sketch modes: ``|sketch AUROC - exact AUROC| <=
        bound``, half the in-bin collision mass, on either grid; per class for
        the multiclass / multilabel layouts."""
        if self.approx is None:
            raise ValueError("error_bound() needs approx='sketch' or 'qsketch'")
        return auroc_error_bound(self.hist.counts)

    def _states_own_sync(self) -> bool:
        from metrics_tpu_torch.parallel.sharded_dispatch import _AUROC_FALLBACK, auroc_applicable, owns_sync

        return owns_sync(self, auroc_applicable(self), _AUROC_FALLBACK, "preds", "target")

    def compute(self) -> Tensor:
        if self.approx is not None:
            return self._sketch_compute()
        from metrics_tpu_torch.parallel.sharded_dispatch import auroc_sharded

        sharded = auroc_sharded(self)  # row-sharded epoch states: the exact ring
        if sharded is not None:
            return sharded
        # the gather path materializes the epoch on every rank: the span makes
        # that O(dataset) cost visible next to the sharded launches
        if TRACE.enabled:
            with _span("auroc.gather_compute", {"rows": len(self.preds) if isinstance(self.preds, list) else -1}):
                return self._gather_compute()
        return self._gather_compute()

    def _gather_compute(self) -> Tensor:
        preds, target = as_values(self.preds), as_values(self.target)
        mode = self.mode
        if mode is None:  # a rank with no update of its own computes from the gathered states
            _, _, mode = _input_format_classification(preds, target, validate=False)
        return _auroc_compute(preds, target, mode, self.num_classes, self.pos_label, self.average, self.max_fpr)
