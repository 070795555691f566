from metrics_tpu_torch.functional.classification.accuracy import accuracy  # noqa: F401
from metrics_tpu_torch.functional.classification.binned_curves import (  # noqa: F401
    binned_auroc,
    binned_average_precision,
    binned_precision_recall_curve,
    binned_roc,
)
from metrics_tpu_torch.functional.classification.f_beta import f1, fbeta  # noqa: F401
from metrics_tpu_torch.functional.classification.precision_recall import (  # noqa: F401
    precision,
    precision_recall,
    recall,
)
from metrics_tpu_torch.functional.classification.stat_scores import stat_scores  # noqa: F401
