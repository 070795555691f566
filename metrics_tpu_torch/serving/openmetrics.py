"""The scrape surface: OpenMetrics text exposition over the serving stack.

Counterpart of ``metrics_tpu/serving/openmetrics.py``, with the same family
names and the ``metrics_tpu`` prefix, so one scraper configuration reads
either package. :func:`render` is a pure function over host dicts (the
counters snapshot and each attached
:class:`~metrics_tpu_torch.serving.retention.RetentionStore`'s latest value):

- the ``service_health``, ``fleet_shards``, ``slab_slots`` and ``retention``
  gauges, and the ``faults`` block as counters (``..._total``);
- the health plane: watermark lag, publish staleness, the lifecycle gauges,
  and the self-metered stage latencies as a summary family;
- each retained stream's newest finished value (keyed streams fan out one
  sample a tenant slot).

The format is strict OpenMetrics 1.0 (``# TYPE`` / ``# HELP`` before samples,
escaped label values, ``# EOF``). :class:`ExpositionServer` serves it at
``GET /metrics`` from a stdlib ``http.server`` on an ephemeral loopback port;
``close()`` shuts the listener down, closes its socket and joins its thread.
"""
import math
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["CONTENT_TYPE", "ExpositionServer", "render"]

# the OpenMetrics 1.0 media type a compliant scraper negotiates for
CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"

_PREFIX = "metrics_tpu"


def _escape_label(value: Any) -> str:
    """OpenMetrics label-value escaping: backslash, double-quote, newline."""
    return (
        str(value)
        .replace("\\", "\\\\")
        .replace('"', '\\"')
        .replace("\n", "\\n")
    )


def _format_value(value: Any) -> str:
    v = float(value)
    if math.isnan(v):
        return "NaN"
    if math.isinf(v):
        return "+Inf" if v > 0 else "-Inf"
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


def _sample(name: str, labels: Sequence[Tuple[str, Any]], value: Any) -> str:
    if labels:
        body = ",".join(f'{k}="{_escape_label(v)}"' for k, v in labels)
        return f"{name}{{{body}}} {_format_value(value)}"
    return f"{name} {_format_value(value)}"


class _Family:
    """One MetricFamily: metadata lines first, then its samples. Families
    with zero samples render metadata anyway — an empty gauge family is
    valid exposition and keeps the scrape schema stable."""

    def __init__(self, name: str, kind: str, help_text: str):
        self.name = name
        self.kind = kind
        self.help = help_text
        self.samples: List[str] = []

    def add(self, labels: Sequence[Tuple[str, Any]], value: Any, suffix: str = "") -> None:
        self.samples.append(_sample(self.name + suffix, labels, value))

    def lines(self) -> List[str]:
        return [
            f"# TYPE {self.name} {self.kind}",
            f"# HELP {self.name} {self.help}",
            *self.samples,
        ]


def render(
    stores: Iterable[Any] = (),
    snapshot: Optional[Dict[str, Any]] = None,
) -> str:
    """The full exposition: observability gauges + retention latest values.

    Args:
        stores: :class:`RetentionStore` instances whose streams' newest
            resolved values should be exposed (each becomes samples of the
            ``metrics_tpu_retained_latest`` gauge family, labeled by store
            and stream; keyed streams fan out one sample per tenant slot).
        snapshot: a counters snapshot dict (``observability.
            counters_snapshot()``); taken live when omitted. Rendering an
            explicit snapshot is how a scrape thread avoids touching the
            counters lock twice.

    Returns the OpenMetrics text exposition, ``# EOF``-terminated.
    """
    if snapshot is None:
        from metrics_tpu_torch.observability.counters import snapshot as counters_snapshot

        snapshot = counters_snapshot()

    health = _Family(
        f"{_PREFIX}_service_health", "gauge",
        "Serving-loop liveness: 1 for the service's current state label.",
    )
    service_gauges = {
        key: _Family(
            f"{_PREFIX}_service_{key}", "gauge",
            f"Per-service {key.replace('_', ' ')} gauge from the health block.",
        )
        for key in ("shed_events", "published", "queue_depth")
    }
    for label, entry in snapshot.get("service_health", {}).items():
        health.add([("service", label), ("state", entry["state"])], 1)
        for key, family in service_gauges.items():
            family.add([("service", label)], entry[key])

    shard_health = _Family(
        f"{_PREFIX}_fleet_shard_health", "gauge",
        "Fleet shard liveness: 1 for the shard's current state label.",
    )
    shard_gauges = {
        key: _Family(
            f"{_PREFIX}_fleet_shard_{key}", "gauge",
            f"Per-shard {key.replace('_', ' ')} gauge from the fleet block.",
        )
        for key in ("queue_depth", "occupied", "published", "replayed")
    }
    for fleet, shards in snapshot.get("fleet_shards", {}).items():
        for shard, entry in shards.items():
            where = [("fleet", fleet), ("shard", shard)]
            shard_health.add([*where, ("state", entry.get("health", "unknown"))], 1)
            for key, family in shard_gauges.items():
                if key in entry:
                    family.add(where, entry[key])

    slab_gauges = {
        key: _Family(
            f"{_PREFIX}_slab_{key}", "gauge",
            f"Keyed-slab {key} gauge (latest refresh wins).",
        )
        for key in ("slots", "occupied", "evictions")
    }
    for label, entry in snapshot.get("slab_slots", {}).items():
        for key, family in slab_gauges.items():
            family.add([("slab", label)], entry[key])

    faults = _Family(
        f"{_PREFIX}_fault", "counter",
        "Fault-path events by kind: retries, deadline hits, degraded"
        " computes, quarantined updates.",
    )
    for kind, count in snapshot.get("faults", {}).items():
        faults.add([("kind", kind)], count, suffix="_total")

    retention_gauges = {
        key: _Family(
            f"{_PREFIX}_retention_{key}", "gauge",
            f"Retention-store {key.replace('_', ' ')} gauge.",
        )
        for key in ("windows_banked", "rollups", "resident_bytes", "queries")
    }
    for label, entry in snapshot.get("retention", {}).items():
        for key, family in retention_gauges.items():
            family.add([("store", label)], entry[key])

    wm_lag = _Family(
        f"{_PREFIX}_watermark_lag_seconds", "gauge",
        "Host wall time minus the agreed event-time watermark at the last"
        " publish — freshness of the close frontier.",
    )
    wm_lag_degraded = _Family(
        f"{_PREFIX}_watermark_lag_degraded", "gauge",
        "1 when the last publish behind this lag reading was degraded.",
    )
    for label, entry in snapshot.get("watermark_lag", {}).items():
        wm_lag.add([("service", label)], entry["lag_s"])
        wm_lag_degraded.add([("service", label)], 1 if entry["degraded"] else 0)

    staleness = _Family(
        f"{_PREFIX}_publish_staleness_seconds", "gauge",
        "Seconds since the service last published a window (ages between"
        " publishes; derived at snapshot time).",
    )
    for label, entry in snapshot.get("publish_staleness", {}).items():
        staleness.add([("service", label)], entry["staleness_s"])

    lifecycle_gauges = {
        key: _Family(
            f"{_PREFIX}_lifecycle_{key}", "gauge",
            f"Window-lifecycle ledger {key.replace('_', ' ')} gauge.",
        )
        for key in ("windows_stamped", "open_windows")
    }
    for label, entry in snapshot.get("lifecycle", {}).items():
        for key, family in lifecycle_gauges.items():
            family.add([("service", label)], entry[key])

    stage_latency = _Family(
        f"{_PREFIX}_stage_latency_ms", "summary",
        "Self-metered pipeline stage latency: certified quantile sketch"
        " reads per (service, stage).",
    )
    for label, stages in snapshot.get("selfmeter", {}).items():
        for stage, summary in stages.items():
            where = [("service", label), ("stage", stage)]
            for q in ("0.5", "0.95", "0.99"):
                value = summary.get(f"p{int(float(q) * 100)}_ms")
                if value is None or math.isnan(float(value)):
                    continue
                stage_latency.add([*where, ("quantile", q)], value)
            stage_latency.add(where, summary["count"], suffix="_count")
            stage_latency.add(where, summary["sum_ms"], suffix="_sum")

    latest = _Family(
        f"{_PREFIX}_retained_latest", "gauge",
        "Newest retained bucket's finished value per stream (keyed streams"
        " fan out one sample per tenant slot).",
    )
    latest_start = _Family(
        f"{_PREFIX}_retained_latest_start_seconds", "gauge",
        "Event-time start of the newest retained bucket.",
    )
    latest_final = _Family(
        f"{_PREFIX}_retained_latest_final", "gauge",
        "1 when the newest retained bucket covers only watermark-closed"
        " windows, 0 when a finalize() flush truncated it.",
    )
    for store in stores:
        for stream in store.labels:
            point = store.latest(metric=stream)
            if point is None:
                continue
            where = [("store", store.label), ("metric", stream)]
            value = np.asarray(point["value"])
            if value.ndim == 0:
                latest.add(where, value)
            else:
                flat = value.reshape(-1)
                for slot in range(flat.shape[0]):
                    latest.add([*where, ("tenant", slot)], flat[slot])
            latest_start.add(where, point["start_s"])
            latest_final.add(where, 1 if point["final"] else 0)

    families = [
        health, *service_gauges.values(),
        shard_health, *shard_gauges.values(),
        *slab_gauges.values(),
        faults,
        *retention_gauges.values(),
        wm_lag, wm_lag_degraded, staleness,
        *lifecycle_gauges.values(),
        stage_latency,
        latest, latest_start, latest_final,
    ]
    lines: List[str] = []
    for family in families:
        lines.extend(family.lines())
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


class ExpositionServer:
    """A stdlib HTTP endpoint serving :func:`render` at ``GET /metrics``.

    Binds an ephemeral loopback port by default (``server.url`` is the
    scrape target), serves from daemon threads, and renders each scrape
    live — the retention stores' locks make the read consistent without
    freezing the write path. ``close()`` (or the context manager) shuts the
    listener down. No new dependencies: this is ``http.server`` all the way
    down, which is exactly enough for a Prometheus scrape loop.
    """

    def __init__(self, stores: Iterable[Any] = (), host: str = "127.0.0.1", port: int = 0):
        self.stores = tuple(stores)
        outer = self

        class _Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 (stdlib handler contract)
                if self.path.split("?", 1)[0] not in ("/metrics", "/"):
                    self.send_error(404, "scrape /metrics")
                    return
                body = render(outer.stores).encode("utf-8")
                self.send_response(200)
                self.send_header("Content-Type", CONTENT_TYPE)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, fmt: str, *args: Any) -> None:
                pass  # scrapes are telemetry; logging them is noise

        self._server = ThreadingHTTPServer((host, port), _Handler)
        self._server.daemon_threads = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="mtpu-torch-exposition", daemon=True
        )
        self._thread.start()

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    @property
    def url(self) -> str:
        host = self._server.server_address[0]
        return f"http://{host}:{self.port}/metrics"

    def close(self) -> None:
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=5.0)

    def __enter__(self) -> "ExpositionServer":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()
