"""Matthews correlation coefficient from confusion-matrix marginals.

Counterpart of ``metrics_tpu/functional/classification/matthews_corrcoef.py``:
the same formula in the same order, in float32.
"""
import torch
from torch import Tensor

from metrics_tpu_torch.functional.classification.confusion_matrix import _confusion_matrix_update

_matthews_corrcoef_update = _confusion_matrix_update


def _matthews_corrcoef_compute(confmat: Tensor) -> Tensor:
    confmat = confmat.to(torch.float32)
    tk = torch.sum(confmat, dim=0)
    pk = torch.sum(confmat, dim=1)
    c = torch.trace(confmat)
    s = torch.sum(confmat)
    denominator = torch.sqrt(s**2 - torch.sum(pk * pk)) * torch.sqrt(s**2 - torch.sum(tk * tk))
    return (c * s - torch.sum(tk * pk)) / denominator


def matthews_corrcoef(
    preds: Tensor,
    target: Tensor,
    num_classes: int,
    threshold: float = 0.5,
) -> Tensor:
    r"""MCC: correlation between prediction and target assignment.

    Example:
        >>> import torch
        >>> target = torch.tensor([1, 1, 0, 0])
        >>> preds = torch.tensor([0, 1, 0, 0])
        >>> round(float(matthews_corrcoef(preds, target, num_classes=2)), 4)
        0.5774
    """
    confmat = _matthews_corrcoef_update(preds, target, num_classes, threshold)
    return _matthews_corrcoef_compute(confmat)
