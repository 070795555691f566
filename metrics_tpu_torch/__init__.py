"""metrics_tpu_torch: the PyTorch/CUDA port of metrics_tpu.

A second package beside ``metrics_tpu`` that mirrors its layout and names
(``core/metric.py``, ``utils/checks.py``, ``ops/binned.py``, ...). It imports
torch and numpy, never jax nor ``metrics_tpu``. States live on the GPU unless
a metric is built with ``device="cpu"``.
"""
from metrics_tpu_torch.core.metric import CompositionalMetric, Metric  # noqa: F401  (first: the classes below subclass it)
from metrics_tpu_torch.classification import (  # noqa: F401
    AUC,
    AUROC,
    F1,
    ROC,
    Accuracy,
    AveragePrecision,
    BinnedAUROC,
    BinnedAveragePrecision,
    BinnedPrecisionRecallCurve,
    BinnedROC,
    FBeta,
    Precision,
    PrecisionRecallCurve,
    Recall,
    StatScores,
)
from metrics_tpu_torch.core.collections import MetricCollection  # noqa: F401

__all__ = [
    "AUC",
    "AUROC",
    "Accuracy",
    "AveragePrecision",
    "BinnedAUROC",
    "BinnedAveragePrecision",
    "BinnedPrecisionRecallCurve",
    "BinnedROC",
    "CompositionalMetric",
    "F1",
    "FBeta",
    "Metric",
    "MetricCollection",
    "Precision",
    "PrecisionRecallCurve",
    "ROC",
    "Recall",
    "StatScores",
]
