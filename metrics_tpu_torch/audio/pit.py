"""PIT module. Counterpart of ``metrics_tpu/audio/pit.py``: the per-example
best-permutation values stream through the sum / count base."""
from typing import Any, Callable, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.streaming import SumCountMetric
from metrics_tpu_torch.functional.audio.pit import permutation_invariant_training


class PIT(SumCountMetric):
    r"""Accumulated permutation-invariant metric (mean of per-example best
    values over source permutations).

    Args:
        metric_func: per-example function reducing the trailing time axis
            (e.g. ``lambda p, t: _si_sdr_per_example(p, t, False)``).
        eval_func: "max" (higher is better) or "min".

    Example:
        >>> import torch
        >>> from metrics_tpu_torch.functional.audio.si_sdr import _si_sdr_per_example
        >>> pit = PIT(lambda p, t: _si_sdr_per_example(p, t, False), device="cpu")
        >>> target = torch.stack([torch.ones((2, 16)), torch.zeros((2, 16)) + 0.5], dim=1)
        >>> _ = pit(target.flip(1), target)  # swapped sources: perfect after matching
        >>> float(pit.compute()) > 40  # ~inf dB capped by eps
        True
    """

    def __init__(
        self,
        metric_func: Callable,
        eval_func: str = "max",
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
        if eval_func not in ("max", "min"):
            raise ValueError(f"`eval_func` must be 'max' or 'min', got {eval_func!r}")
        self.metric_func = metric_func
        self.eval_func = eval_func

    def _update_stats(self, preds: Tensor, target: Tensor) -> Tuple[Tensor, Any]:
        best, _ = permutation_invariant_training(preds, target, self.metric_func, self.eval_func)
        return torch.sum(best), best.shape[0]
