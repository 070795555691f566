"""Metric wrappers: BootStrapper, ClasswiseWrapper, HeavyHitters, Keyed,
MinMaxMetric, MetricTracker, MultioutputWrapper, Running, Windowed.

Counterpart of ``metrics_tpu/wrappers/``. ``Keyed`` and ``HeavyHitters`` are
the multi-tenant slab wrappers (one metric x thousands of segments as a
leading state axis) and ``Windowed`` the event-time window ring over the same
slabs, where the cloning wrappers (Classwise, Multioutput) fan out whole
modules."""
from metrics_tpu_torch.wrappers.bootstrapper import BootStrapper  # noqa: F401
from metrics_tpu_torch.wrappers.classwise import ClasswiseWrapper  # noqa: F401
from metrics_tpu_torch.wrappers.heavy_hitters import HeavyHitters, SpaceSavingTable  # noqa: F401
from metrics_tpu_torch.wrappers.keyed import Keyed  # noqa: F401
from metrics_tpu_torch.wrappers.minmax import MinMaxMetric  # noqa: F401
from metrics_tpu_torch.wrappers.multioutput import MultioutputWrapper  # noqa: F401
from metrics_tpu_torch.wrappers.running import Running  # noqa: F401
from metrics_tpu_torch.wrappers.tracker import MetricTracker  # noqa: F401
from metrics_tpu_torch.wrappers.windowed import Windowed  # noqa: F401

__all__ = [
    "BootStrapper", "ClasswiseWrapper", "HeavyHitters", "Keyed", "MinMaxMetric",
    "MetricTracker", "MultioutputWrapper", "Running", "SpaceSavingTable", "Windowed",
]
