from metrics_tpu_torch.core.collections import MetricCollection  # noqa: F401
from metrics_tpu_torch.core.metric import CompositionalMetric, Metric, PureMetric  # noqa: F401
