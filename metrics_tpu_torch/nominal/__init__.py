"""Nominal association metrics. Counterpart of ``metrics_tpu/nominal/``.

All four stream the same ``(num_classes_preds, num_classes_target)`` int64
contingency state; see ``metrics_tpu_torch/functional/nominal.py``.
"""
from metrics_tpu_torch.nominal.association import (
    CramersV,
    PearsonsContingencyCoefficient,
    TheilsU,
    TschuprowsT,
)

__all__ = ["CramersV", "PearsonsContingencyCoefficient", "TheilsU", "TschuprowsT"]
