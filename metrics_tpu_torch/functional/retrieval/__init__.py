from metrics_tpu_torch.functional.retrieval.average_precision import retrieval_average_precision  # noqa: F401
from metrics_tpu_torch.functional.retrieval.fall_out import retrieval_fall_out  # noqa: F401
from metrics_tpu_torch.functional.retrieval.hit_rate import retrieval_hit_rate  # noqa: F401
from metrics_tpu_torch.functional.retrieval.ndcg import retrieval_normalized_dcg  # noqa: F401
from metrics_tpu_torch.functional.retrieval.precision import retrieval_precision  # noqa: F401
from metrics_tpu_torch.functional.retrieval.r_precision import retrieval_r_precision  # noqa: F401
from metrics_tpu_torch.functional.retrieval.recall import retrieval_recall  # noqa: F401
from metrics_tpu_torch.functional.retrieval.reciprocal_rank import retrieval_reciprocal_rank  # noqa: F401
from metrics_tpu_torch.functional.retrieval.segments import (  # noqa: F401
    grouped_average_precision,
    grouped_fall_out,
    grouped_hit_rate,
    grouped_ndcg,
    grouped_r_precision,
    grouped_reciprocal_rank,
    grouped_topk_hits,
    segment_positions,
    sort_by_query_then_score,
    within_segment_cumsum,
)
