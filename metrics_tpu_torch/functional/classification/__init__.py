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
