"""Serving runtime: the supervised streaming loop around the window plane.

Counterpart of ``metrics_tpu/serving/``. ``MetricService`` owns update ->
window roll -> guarded sync -> publish for a
:class:`~metrics_tpu_torch.wrappers.windowed.Windowed` metric (a bounded
ingress queue with a shed policy, degrade over stall, crash-safe snapshot and
restore, health gauges). ``MetricFleet`` scales it over N hash-partitioned
shards and a merge tier; ``HeavyHitterFleet`` routes open-world keys.
``RetentionStore`` banks closed windows' partials on a resolution ladder and
serves them back through a query plane; ``ExpositionServer`` / ``render``
expose the latest values and the gauges as OpenMetrics text.
"""
from metrics_tpu_torch.serving.fleet import (
    FLEET_SITE,
    HeavyHitterFleet,
    MetricFleet,
    ShardStoppedError,
    shard_for_key,
    shards_for_keys,
    stable_key_hash,
)
from metrics_tpu_torch.serving.openmetrics import CONTENT_TYPE, ExpositionServer, render
from metrics_tpu_torch.serving.retention import RetentionRung, RetentionStore
from metrics_tpu_torch.serving.service import HEALTH_STATES, MetricService, ServiceStoppedError

__all__ = [
    "CONTENT_TYPE",
    "FLEET_SITE",
    "HEALTH_STATES",
    "ExpositionServer",
    "HeavyHitterFleet",
    "MetricFleet",
    "MetricService",
    "RetentionRung",
    "RetentionStore",
    "ServiceStoppedError",
    "ShardStoppedError",
    "render",
    "shard_for_key",
    "shards_for_keys",
    "stable_key_hash",
]
