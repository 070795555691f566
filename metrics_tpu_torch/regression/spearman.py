"""SpearmanCorrcoef module, exact or sketched. Counterpart of ``metrics_tpu/regression/spearman.py``."""
import torch
from torch import Tensor

from metrics_tpu_torch.functional.regression.spearman import _spearman_kernel
from metrics_tpu_torch.parallel.sharded_dispatch import spearman_sharded
from metrics_tpu_torch.parallel.sketch import spearman_from_joint
from metrics_tpu_torch.regression._rank_corr import _RankCorrelation


class SpearmanCorrcoef(_RankCorrelation):
    r"""Accumulated Spearman rank correlation over every pair seen (list
    states, or PaddedBuffers with ``capacity``), or over a joint histogram
    (``approx="sketch"`` / ``"qsketch"``): the binned-rank (midrank)
    correlation, scipy's tie-averaged Spearman of the binned data.

    Example:
        >>> import torch
        >>> target = torch.tensor([3.0, -0.5, 2.0, 1.0])
        >>> preds = torch.tensor([2.5, 0.0, 2.0, 1.5])
        >>> spearman = SpearmanCorrcoef(device="cpu")
        >>> float(spearman(preds, target))
        1.0
    """

    _EXACT_WARNING = (
        "Metric `SpearmanCorrcoef` stores every prediction and target in an"
        " O(samples) buffer state (ranks are global over the epoch), so"
        " memory and sync traffic grow with the dataset. Construct with"
        " `approx=\"qsketch\"` for a constant-memory RANGE-FREE joint rank"
        " sketch on the log-bucketed relative-accuracy grid, or"
        " `approx=\"sketch\"` for the fixed-grid variant — both sync with"
        " one all_reduce; exact buffers remain the default."
    )

    def compute(self) -> Tensor:
        if self.approx is not None:
            return spearman_from_joint(self.joint.counts)
        sharded = spearman_sharded(self)  # row-sharded epoch states: global midranks on the ring
        if sharded is not None:
            return sharded
        preds, target = self._epoch()
        if preds.shape[0] == 0:
            return torch.tensor(float("nan"), device=self.device)  # no data, as the functional
        return _spearman_kernel(preds, target)
