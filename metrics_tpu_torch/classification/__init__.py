from metrics_tpu_torch.classification.stat_scores import StatScores  # noqa: F401  (first: the others build on it)
from metrics_tpu_torch.classification.accuracy import Accuracy  # noqa: F401
from metrics_tpu_torch.classification.binned import (  # noqa: F401
    BinnedAUROC,
    BinnedAveragePrecision,
    BinnedPrecisionRecallCurve,
    BinnedROC,
)
from metrics_tpu_torch.classification.f_beta import F1, FBeta  # noqa: F401
from metrics_tpu_torch.classification.precision_recall import Precision, Recall  # noqa: F401
from metrics_tpu_torch.classification.auc import AUC  # noqa: F401
from metrics_tpu_torch.classification.auroc import AUROC  # noqa: F401
from metrics_tpu_torch.classification.average_precision import AveragePrecision  # noqa: F401
from metrics_tpu_torch.classification.precision_recall_curve import PrecisionRecallCurve  # noqa: F401
from metrics_tpu_torch.classification.roc import ROC  # noqa: F401
