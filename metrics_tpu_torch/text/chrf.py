"""CHRFScore module. Counterpart of ``metrics_tpu/text/chrf.py`` (sacrebleu
chrF2 conventions — see ``functional/text_chrf.py``)."""
from typing import Any, Callable, Optional, Sequence, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.text_chrf import CHRF_CHAR_ORDER, chrf_from_stats, chrf_stats
from metrics_tpu_torch.utils.data import accum_int_dtype


class CHRFScore(Metric):
    """Accumulated corpus chrF: per-order character n-gram statistics sum
    across updates (and ranks), the F-score computes from the corpus totals —
    the sacrebleu aggregation. ``compute`` reads the ``(3, order)`` totals back
    to the host once.

    Example:
        >>> metric = CHRFScore(device="cpu")
        >>> round(float(metric(["the cat sat"], ["the cat sat"])), 4)
        1.0
    """

    def __init__(
        self,
        n_char_order: int = CHRF_CHAR_ORDER,
        beta: float = 2.0,
        lowercase: bool = False,
        whitespace: bool = False,
        eps_smoothing: bool = False,
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
        if not isinstance(n_char_order, int) or n_char_order < 1:
            raise ValueError(f"`n_char_order` must be a positive int, got {n_char_order!r}")
        if beta <= 0:
            raise ValueError(f"`beta` must be positive, got {beta!r}")
        self.n_char_order = n_char_order
        self.beta = float(beta)
        self.lowercase = lowercase
        self.whitespace = whitespace
        self.eps_smoothing = eps_smoothing
        self.add_state(
            "stats", default=torch.zeros((3, n_char_order), dtype=accum_int_dtype()), dist_reduce_fx="sum"
        )

    def update(self, preds: Union[str, Sequence[str]], target: Union[str, Sequence[str]]) -> None:
        batch = chrf_stats(preds, target, self.n_char_order, self.lowercase, self.whitespace)
        # each update adds up to max(batch) to an int count state
        self.note_count(int(batch.max()))
        self.stats = self.stats + torch.from_numpy(batch).to(self.device)

    def compute(self) -> Tensor:
        value = chrf_from_stats(self.stats.cpu().numpy(), self.beta, self.eps_smoothing)
        return torch.tensor(value, dtype=torch.float32, device=self.device)
