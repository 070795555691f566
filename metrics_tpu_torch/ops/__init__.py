"""Hand-written CUDA kernels for the hot ops, each beside its plain PyTorch version."""
from metrics_tpu_torch.ops.binned import binned_stat_counts  # noqa: F401
