from metrics_tpu_torch.functional.classification.accuracy import accuracy  # noqa: F401
from metrics_tpu_torch.functional.classification.auc import auc  # noqa: F401
from metrics_tpu_torch.functional.classification.auroc import auroc  # noqa: F401
from metrics_tpu_torch.functional.classification.average_precision import average_precision  # noqa: F401
from metrics_tpu_torch.functional.classification.binned_curves import (  # noqa: F401
    binned_auroc,
    binned_average_precision,
    binned_precision_recall_curve,
    binned_roc,
)
from metrics_tpu_torch.functional.classification.dice import dice_score  # noqa: F401
from metrics_tpu_torch.functional.classification.f_beta import f1, fbeta  # noqa: F401
from metrics_tpu_torch.functional.classification.precision_recall import (  # noqa: F401
    precision,
    precision_recall,
    recall,
)
from metrics_tpu_torch.functional.classification.precision_recall_curve import precision_recall_curve  # noqa: F401
from metrics_tpu_torch.functional.classification.roc import roc  # noqa: F401
from metrics_tpu_torch.functional.classification.stat_scores import stat_scores  # noqa: F401
from metrics_tpu_torch.functional.classification.confusion_matrix import confusion_matrix  # noqa: F401
from metrics_tpu_torch.functional.classification.iou import iou  # noqa: F401
from metrics_tpu_torch.functional.classification.cohen_kappa import cohen_kappa  # noqa: F401
from metrics_tpu_torch.functional.classification.matthews_corrcoef import matthews_corrcoef  # noqa: F401
from metrics_tpu_torch.functional.classification.specificity import specificity  # noqa: F401
from metrics_tpu_torch.functional.classification.hamming_distance import hamming_distance  # noqa: F401
from metrics_tpu_torch.functional.classification.exact_match import exact_match  # noqa: F401
from metrics_tpu_torch.functional.classification.csi import critical_success_index  # noqa: F401
from metrics_tpu_torch.functional.classification.calibration_error import calibration_error  # noqa: F401
from metrics_tpu_torch.functional.classification.hinge import hinge_loss  # noqa: F401
from metrics_tpu_torch.functional.classification.ranking import (  # noqa: F401
    coverage_error,
    label_ranking_average_precision,
    label_ranking_loss,
)
