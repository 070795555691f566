"""SQuAD module. Counterpart of ``metrics_tpu/text/squad.py``. Streams
best-over-references EM and F1 sums (float32) plus a question count (int64) —
the accumulated value equals the official script over the concatenated
dataset."""
from typing import Any, Callable, Dict, Optional, Sequence, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.text_squad import _squad_batch_sums
from metrics_tpu_torch.utils.data import accum_int_dtype


class SQuAD(Metric):
    r"""Accumulated SQuAD exact-match / F1 (percentages, official semantics).

    Example:
        >>> metric = SQuAD(device="cpu")
        >>> out = metric(["the cat"], [["The cat!", "a dog"]])
        >>> (float(out["exact_match"]), float(out["f1"]))
        (100.0, 100.0)
    """

    def __init__(
        self,
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
        self.add_state("em_sum", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("f1_sum", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("questions", default=torch.zeros((), dtype=accum_int_dtype()), dist_reduce_fx="sum")

    def update(
        self,
        preds: Union[str, Sequence[str]],
        target: Union[str, Sequence[str], Sequence[Sequence[str]]],
    ) -> None:
        em_sum, f1_sum, n = _squad_batch_sums(preds, target)
        self.note_count(n)
        self.em_sum = self.em_sum + em_sum
        self.f1_sum = self.f1_sum + f1_sum
        self.questions = self.questions + n

    def compute(self) -> Dict[str, Tensor]:
        n = torch.clamp_min(self.questions, 1).to(torch.float32)
        return {"exact_match": 100.0 * self.em_sum / n, "f1": 100.0 * self.f1_sum / n}
