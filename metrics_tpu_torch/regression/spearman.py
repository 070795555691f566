"""SpearmanCorrcoef module, exact mode. Counterpart of ``metrics_tpu/regression/spearman.py``."""
import torch
from torch import Tensor

from metrics_tpu_torch.functional.regression.spearman import _spearman_kernel
from metrics_tpu_torch.regression._rank_corr import _RankCorrelation


class SpearmanCorrcoef(_RankCorrelation):
    r"""Accumulated Spearman rank correlation over every pair seen (list
    states, or PaddedBuffers with ``capacity``). ``approx=`` raises
    ``NotImplementedError``: the sketch modes are not ported yet.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 1.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 1.5])
        >>> spearman = SpearmanCorrcoef(device="cpu")
        >>> float(spearman(preds, target))
        1.0
    """

    def compute(self) -> Tensor:
        preds, target = self._epoch()
        if preds.shape[0] == 0:
            return torch.tensor(float("nan"), device=self.device)  # no data, as the functional
        return _spearman_kernel(preds, target)
