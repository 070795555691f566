from metrics_tpu_torch.utils.data import (  # noqa: F401
    ClassScores,
    apply_to_collection,
    dim_zero_cat,
    dim_zero_max,
    dim_zero_mean,
    dim_zero_min,
    dim_zero_sum,
    get_group_indexes,
    get_num_classes,
    select_topk,
    to_categorical,
    to_onehot,
)
from metrics_tpu_torch.utils.enums import AverageMethod, DataType, MDMCAverageMethod  # noqa: F401
from metrics_tpu_torch.utils.prints import rank_zero_debug, rank_zero_info, rank_zero_warn  # noqa: F401
from metrics_tpu_torch.utils.reductions import class_reduce, reduce  # noqa: F401
