"""KendallRankCorrCoef module, exact mode. Counterpart of ``metrics_tpu/regression/kendall.py``."""
import torch
from torch import Tensor

from metrics_tpu_torch.functional.regression.kendall import _kendall_kernel, _warn_if_quadratic
from metrics_tpu_torch.regression._rank_corr import _RankCorrelation


class KendallRankCorrCoef(_RankCorrelation):
    r"""Accumulated Kendall rank correlation (tau-b, tie-corrected) over every
    pair seen. The epoch compute is O(N^2) in the accumulated length, walked in
    row blocks (``functional/regression/kendall.py``); keep an epoch below
    ~100k samples. ``approx=`` raises ``NotImplementedError``.

    Example:
        >>> import torch
        >>> preds = torch.tensor([1.0, 2.0, 3.0, 4.0])
        >>> target = torch.tensor([1.0, 3.0, 2.0, 4.0])
        >>> kendall = KendallRankCorrCoef(device="cpu")
        >>> round(float(kendall(preds, target)), 4)
        0.6667
    """

    _score_kind = "scalar scores"

    def compute(self) -> Tensor:
        preds, target = self._epoch()
        if preds.shape[0] < 2:
            return torch.tensor(float("nan"), device=self.device)
        _warn_if_quadratic(preds.shape[0])
        return _kendall_kernel(preds, target)
