from metrics_tpu_torch.classification.stat_scores import StatScores  # noqa: F401  (first: the others build on it)
from metrics_tpu_torch.classification.accuracy import Accuracy  # noqa: F401
from metrics_tpu_torch.classification.binned import (  # noqa: F401
    BinnedAUROC,
    BinnedAveragePrecision,
    BinnedPrecisionRecallCurve,
    BinnedROC,
)
from metrics_tpu_torch.classification.f_beta import Dice, F1, FBeta  # noqa: F401
from metrics_tpu_torch.classification.precision_recall import Precision, Recall  # noqa: F401
from metrics_tpu_torch.classification.auc import AUC  # noqa: F401
from metrics_tpu_torch.classification.auroc import AUROC  # noqa: F401
from metrics_tpu_torch.classification.average_precision import AveragePrecision  # noqa: F401
from metrics_tpu_torch.classification.precision_recall_curve import PrecisionRecallCurve  # noqa: F401
from metrics_tpu_torch.classification.roc import ROC  # noqa: F401
from metrics_tpu_torch.classification.confusion_matrix import ConfusionMatrix  # noqa: F401
from metrics_tpu_torch.classification.iou import IoU, JaccardIndex  # noqa: F401
from metrics_tpu_torch.classification.cohen_kappa import CohenKappa  # noqa: F401
from metrics_tpu_torch.classification.matthews_corrcoef import MatthewsCorrcoef  # noqa: F401
from metrics_tpu_torch.classification.specificity import Specificity  # noqa: F401
from metrics_tpu_torch.classification.hamming_distance import HammingDistance  # noqa: F401
from metrics_tpu_torch.classification.exact_match import ExactMatch  # noqa: F401
from metrics_tpu_torch.classification.csi import CriticalSuccessIndex  # noqa: F401
from metrics_tpu_torch.classification.calibration_error import CalibrationError  # noqa: F401
from metrics_tpu_torch.classification.hinge import HingeLoss  # noqa: F401
from metrics_tpu_torch.classification.ranking import (  # noqa: F401
    CoverageError,
    LabelRankingAveragePrecision,
    LabelRankingLoss,
)
