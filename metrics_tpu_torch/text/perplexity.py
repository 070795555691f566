"""Perplexity module. Counterpart of ``metrics_tpu/text/perplexity.py``."""
from typing import Any, Callable, Optional, Tuple, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.streaming import SumCountMetric
from metrics_tpu_torch.functional.text_perplexity import _perplexity_update


class Perplexity(SumCountMetric):
    r"""Accumulated perplexity: ``exp`` of the mean token NLL over all
    tokens seen (a float32 ``total`` and an int64 ``count``, one ``all_reduce`` to sync).

    Args:
        ignore_index: target id excluded from the likelihood (padding).

    Example:
        >>> import torch
        >>> logits = torch.log(torch.tensor([[[0.25, 0.75], [0.5, 0.5]]]))
        >>> metric = Perplexity(device="cpu")
        >>> round(float(metric(logits, torch.tensor([[1, 0]]))), 4)
        1.633
    """

    def __init__(
        self,
        ignore_index: Optional[int] = None,
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
        if ignore_index is not None and not isinstance(ignore_index, int):
            raise ValueError(f"`ignore_index` must be an int or None, got {ignore_index!r}")
        self.ignore_index = ignore_index

    def _update_stats(self, preds: Tensor, target: Tensor) -> Tuple[Tensor, Any]:
        return _perplexity_update(preds, target, self.ignore_index)

    def _finalize(self, mean: Tensor) -> Tensor:
        return torch.exp(mean)
