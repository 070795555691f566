from metrics_tpu_torch.functional.classification import (  # noqa: F401
    accuracy,
    binned_auroc,
    binned_average_precision,
    binned_precision_recall_curve,
    binned_roc,
    f1,
    fbeta,
    precision,
    precision_recall,
    recall,
    stat_scores,
)
