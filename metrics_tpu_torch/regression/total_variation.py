"""TotalVariation module: a float32 TV sum and an int64 image count.
Counterpart of ``metrics_tpu/regression/total_variation.py``."""
from typing import Any, Callable, Optional, Union

import torch
from torch import Tensor

from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.functional.regression.total_variation import _total_variation_update


class TotalVariation(Metric):
    r"""Accumulated anisotropic total variation: the total over all images
    (``'sum'``) or the mean per image (``'mean'``).

    Example:
        >>> import torch
        >>> tv = TotalVariation(device="cpu")
        >>> img = torch.arange(16.0).reshape(1, 1, 4, 4)
        >>> float(tv(img))
        60.0
    """

    def __init__(
        self,
        reduction: str = "sum",
        compute_on_step: bool = True,
        dist_sync_on_step: bool = False,
        process_group: Optional[Any] = None,
        dist_sync_fn: Optional[Callable] = None,
        device: Optional[Union[str, torch.device]] = None,
    ):
        super().__init__(compute_on_step=compute_on_step, dist_sync_on_step=dist_sync_on_step,
                         process_group=process_group, dist_sync_fn=dist_sync_fn, device=device)
        if reduction not in ("sum", "mean"):
            raise ValueError(f"Expected reduction to be 'sum' or 'mean', got {reduction}")
        self.reduction = reduction
        self.add_state("score", default=torch.zeros((), dtype=torch.float32), dist_reduce_fx="sum")
        self.add_state("num_images", default=torch.zeros((), dtype=torch.int64), dist_reduce_fx="sum")

    def update(self, img: Tensor) -> None:
        score, n = _total_variation_update(img)
        self.score = self.score + score
        self.num_images = self.num_images + n

    def compute(self) -> Tensor:
        if self.reduction == "mean":
            return self.score / torch.clamp_min(self.num_images.to(torch.float32), 1.0)
        return self.score
