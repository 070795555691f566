"""TranslationEditRate module. Counterpart of ``metrics_tpu/text/ter.py``
(Tercom semantics — see ``functional/text_ter.py``)."""
from typing import Any, Callable, Optional, Sequence, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.text_ter import ter_from_stats, ter_stats


class TranslationEditRate(Metric):
    """Accumulated corpus TER: per-segment best edit counts (shifts +
    Levenshtein, minimum over references) and average reference lengths sum
    across updates in float32 states, the rate computes from the corpus totals
    — the Tercom/sacrebleu aggregation. Lower is better.

    Example:
        >>> metric = TranslationEditRate(device="cpu")
        >>> round(float(metric(["the cat sat on mat"],
        ...                    [["the cat sat on the mat"]])), 4)
        0.1667
    """

    def __init__(
        self,
        case_sensitive: bool = False,
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
        self.case_sensitive = case_sensitive
        self.add_state("total_edits", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("total_ref_len", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")

    def update(self, preds: Union[str, Sequence[str]], target: Sequence[Sequence[str]]) -> None:
        edits, ref_len = ter_stats(preds, target, self.case_sensitive)
        self.total_edits = self.total_edits + edits
        self.total_ref_len = self.total_ref_len + ref_len

    def compute(self) -> Tensor:
        value = ter_from_stats(float(self.total_edits), float(self.total_ref_len))
        return torch.tensor(value, dtype=torch.float32, device=self.device)
