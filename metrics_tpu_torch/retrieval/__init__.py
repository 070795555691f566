from metrics_tpu_torch.retrieval.fall_out import RetrievalFallOut  # noqa: F401
from metrics_tpu_torch.retrieval.hit_rate import RetrievalHitRate  # noqa: F401
from metrics_tpu_torch.retrieval.mean_average_precision import RetrievalMAP  # noqa: F401
from metrics_tpu_torch.retrieval.ndcg import RetrievalNormalizedDCG  # noqa: F401
from metrics_tpu_torch.retrieval.precision import RetrievalPrecision  # noqa: F401
from metrics_tpu_torch.retrieval.r_precision import RetrievalRPrecision  # noqa: F401
from metrics_tpu_torch.retrieval.recall import RetrievalRecall  # noqa: F401
from metrics_tpu_torch.retrieval.reciprocal_rank import RetrievalMRR  # noqa: F401
from metrics_tpu_torch.retrieval.retrieval_metric import IGNORE_IDX, RetrievalMetric  # noqa: F401
