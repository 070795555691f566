"""CriticalSuccessIndex module.

Counterpart of ``metrics_tpu/classification/csi.py``: the threat score
TP / (TP + FN + FP) of forecast verification over int64 ``tp`` and
``fp_fn`` "sum" states; ``nan`` when no event is predicted or observed.
"""
from typing import Any, Callable, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.classification.csi import _csi_compute, _csi_update


class CriticalSuccessIndex(Metric):
    """Accumulated CSI at ``threshold``.

    Example:
        >>> import torch
        >>> metric = CriticalSuccessIndex(threshold=0.5, device="cpu")
        >>> float(metric(torch.tensor([0.9, 0.4]), torch.tensor([1.0, 0.0])))
        1.0
    """

    def __init__(
        self,
        threshold: float = 0.5,
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
        self.threshold = float(threshold)
        self.add_state("tp", default=torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")
        self.add_state("fp_fn", default=torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")

    def update(self, preds: Tensor, target: Tensor) -> None:
        tp, fp_fn = _csi_update(preds, target, self.threshold)
        self.tp = self.tp + tp
        self.fp_fn = self.fp_fn + fp_fn

    def compute(self) -> Tensor:
        return _csi_compute(self.tp, self.fp_fn)
