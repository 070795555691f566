"""The port's OpenMetrics exposition against the JAX package's.

* ``render`` is text-equal to the JAX package's for the same counters snapshot
  and retention stores fed the same stream (a plain and a keyed stream, a
  service label with quotes, a newline and a backslash), and passes the strict
  validator of ``tests/serving/test_openmetrics.py`` with every gauge, counter
  and summary family present;
* ``ExpositionServer`` serves it at ``GET /metrics`` on ``127.0.0.1`` with an
  ephemeral port and ``CONTENT_TYPE``, answers 404 elsewhere, survives six
  concurrent scrapers while a service publishes, and ``close()`` joins its
  thread and frees the port.

Tolerances: the texts are equal; the latest values they carry come from
equal counts (Accuracy), so they are equal too.
"""
import socket
import threading
import urllib.error
import urllib.request

import numpy as np
import pytest

import metrics_tpu as mt
import metrics_tpu.serving as jserving
import metrics_tpu_torch as pt
import metrics_tpu_torch.observability as pobs
import metrics_tpu_torch.serving as pserving
from tests.serving.test_openmetrics import _parse_strict, _sample_map
from tests.test_torch_faults import plane_hygiene  # noqa: F401  (autouse)
from tests.test_torch_observability import obs_hygiene  # noqa: F401  (autouse)
from tests.test_torch_serving_service import CPU, W, serving_hygiene  # noqa: F401  (autouse)

_HOSTILE = 'svc "quoted"\nnewlined\\slashed'


def _run_service(pkg, name, n_batches=16, keyed=False, seed=0):
    """A synchronous-stage service over ``Windowed(Accuracy)`` (or a 3-slot
    ``Keyed`` inner) with a retention store attached; returns the store."""
    kw = {} if pkg is mt else CPU
    inner = pkg.Keyed(pkg.Accuracy(**kw), num_slots=3) if keyed else pkg.Accuracy(**kw)
    svc = pkg.MetricService(pkg.Windowed(inner, window_s=W, num_windows=4, allowed_lateness_s=0.0),
                            name=name, deferred_publish=False)
    store = pkg.RetentionStore(name=f"{name}-store").attach(svc)
    rng = np.random.RandomState(seed)
    for i in range(n_batches):
        kwargs = {"slot": rng.randint(0, 3, 8).astype(np.int32)} if keyed else {}
        svc.submit(rng.rand(8).astype(np.float32), rng.randint(0, 2, 8).astype(np.int32),
                   event_time=np.full(8, i * 5.0), **kwargs)
    svc.finalize()
    svc.stop()
    return store


def test_render_is_text_equal_to_jax_and_strict():
    pobs.enable()
    stores = {pkg: [_run_service(pkg, _HOSTILE), _run_service(pkg, "svc-keyed-om", keyed=True, seed=1)]
              for pkg in (mt, pt)}
    snap = pobs.counters_snapshot()
    text = pserving.render(stores[pt], snapshot=snap)
    assert text == jserving.render(stores[mt], snapshot=snap)
    families = _parse_strict(text)
    for name in ("metrics_tpu_service_health", "metrics_tpu_service_published",
                 "metrics_tpu_service_shed_events", "metrics_tpu_service_queue_depth",
                 "metrics_tpu_fleet_shard_health", "metrics_tpu_fleet_shard_queue_depth",
                 "metrics_tpu_slab_slots", "metrics_tpu_fault",
                 "metrics_tpu_retention_windows_banked", "metrics_tpu_retention_rollups",
                 "metrics_tpu_retention_resident_bytes", "metrics_tpu_retention_queries",
                 "metrics_tpu_watermark_lag_seconds", "metrics_tpu_publish_staleness_seconds",
                 "metrics_tpu_lifecycle_windows_stamped", "metrics_tpu_stage_latency_ms",
                 "metrics_tpu_retained_latest", "metrics_tpu_retained_latest_final"):
        assert name in families and families[name]["help"], name
    health = {labels["service"]: labels["state"] for _, labels, _ in families["metrics_tpu_service_health"]["samples"]}
    assert health[_HOSTILE] == "healthy"  # the label escaping round-trips
    assert families["metrics_tpu_fault"]["type"] == "counter"
    latest = families["metrics_tpu_retained_latest"]["samples"]
    assert len(latest) == 1 + 3  # the keyed stream fans out one sample a tenant slot
    stamped = _sample_map(families["metrics_tpu_lifecycle_windows_stamped"])
    assert stamped[(("service", _HOSTILE),)] == "8"  # 16 batches 5 s apart: 8 windows of 10 s
    banked = _sample_map(families["metrics_tpu_retention_windows_banked"])
    assert banked[(("store", f"{_HOSTILE}-store"),)] == str(stores[pt][0].windows_banked)


def test_render_of_an_explicit_snapshot_without_stores():
    snap = pobs.counters_snapshot()
    text = pserving.render(snapshot=snap)
    assert text == jserving.render(snapshot=snap)
    families = _parse_strict(text)
    assert families["metrics_tpu_retained_latest"]["samples"] == []
    _parse_strict(pserving.render())  # a live snapshot


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.status, resp.headers["Content-Type"], resp.read().decode("utf-8")


def test_http_scrape_concurrent_scrapes_and_close():
    pobs.enable()
    store = _run_service(pt, "svc-http")
    server = pserving.ExpositionServer([store])
    assert server.url == f"http://127.0.0.1:{server.port}/metrics" and server.port > 0
    status, content_type, body = _get(server.url)
    assert status == 200 and content_type == pserving.CONTENT_TYPE == jserving.CONTENT_TYPE
    assert _parse_strict(body).keys() == _parse_strict(pserving.render([store])).keys()
    with pytest.raises(urllib.error.HTTPError):
        urllib.request.urlopen(f"http://127.0.0.1:{server.port}/nope", timeout=10)

    bodies, errors = [], []

    def scrape():
        try:
            for _ in range(5):
                bodies.append(_get(server.url)[2])
        except Exception as exc:  # noqa: BLE001 - surfaced after the join
            errors.append(exc)

    threads = [threading.Thread(target=scrape) for _ in range(6)]
    for t in threads:
        t.start()
    _run_service(pt, "svc-scrape-writer", n_batches=8)  # the write path races the reads
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads) and errors == [] and len(bodies) == 30
    assert len({frozenset(_parse_strict(b)) for b in bodies}) == 1  # the family schema never flickers

    port, thread = server.port, server._thread
    server.close()
    assert not thread.is_alive()
    with socket.socket() as s:
        assert s.connect_ex(("127.0.0.1", port)) != 0  # the listener is gone
    with pserving.ExpositionServer() as again:  # the context manager closes too
        assert _get(again.url)[0] == 200
    assert not again._thread.is_alive()
