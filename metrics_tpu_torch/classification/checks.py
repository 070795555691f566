"""Deprecated import location of the classification input checks, kept as the
JAX package keeps it (``metrics_tpu/classification/checks.py``): it
re-exports them from ``metrics_tpu_torch.utils.checks`` and warns at import."""
from metrics_tpu_torch.utils.checks import (  # noqa: F401
    _check_classification_inputs,
    _input_format_classification,
    _input_format_classification_one_hot,
)
from metrics_tpu_torch.utils.prints import rank_zero_warn

rank_zero_warn(
    "`metrics_tpu_torch.classification.checks` is deprecated; import from `metrics_tpu_torch.utils.checks` instead.",
    DeprecationWarning,
)
