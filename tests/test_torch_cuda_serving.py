"""The serving plane on the card, held against the same objects on the CPU.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is false.
This file imports no JAX, so it runs on a GPU machine without the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_serving.py

* a ``MetricService`` over ``Windowed(AUROC(approx="sketch"))`` with its
  batches as tensors on the card (coalesced on the card with ``torch.cat``)
  and over ``Windowed(Accuracy)`` with host batches: every publication and the
  merged value equal the CPU service's, deferred and synchronous stages alike,
  and the worker thread ran on the metric's card;
* a 4-shard ``MetricFleet`` of ``Windowed(Accuracy)`` on the card: merged
  records equal the CPU fleet's;
* a ``RetentionStore`` attached to a card service: queries and ``latest``
  equal the CPU store's, and its buckets are host numpy;
* ``HeavyHitterFleet`` on the card: top-k equals the CPU fleet's.

Tolerances: counts, windows and flags are equal; the sketch curves from equal
counts within rtol 1e-6 (the finisher's float order), Accuracy values equal.
"""
import threading

import numpy as np
import pytest
import torch

import metrics_tpu_torch as pt

RTOL = 1e-6
W = 10.0


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture(autouse=True)
def _no_service_left(monkeypatch):
    """Records every service, fleet and exposition server the test builds and
    stops them afterwards, even when the test failed, so that no worker still
    touches the card at exit; then drains the host plane and asserts that no
    service worker is alive."""
    from metrics_tpu_torch.parallel.deferred import drain_host_plane

    made = []
    for cls in (pt.MetricService, pt.MetricFleet, pt.ExpositionServer):
        def init(self, *args, _original=cls.__init__, **kwargs):
            _original(self, *args, **kwargs)
            made.append(self)

        monkeypatch.setattr(cls, "__init__", init)
    yield
    monkeypatch.undo()
    for obj in reversed(made):
        try:
            obj.close() if isinstance(obj, pt.ExpositionServer) else obj.stop(10.0)
        except BaseException:  # noqa: BLE001 - a failed test's object still has to stop
            pass
    drain_host_plane()
    alive = []
    for thread in threading.enumerate():
        if thread.name.startswith("mtpu-service-"):
            thread.join(5.0)
            if thread.is_alive():
                alive.append(thread.name)
    assert not alive, alive


def _stream(n=24, size=64, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        t = i * 2.5 + rng.uniform(0.0, 2.5, size)
        labels = (rng.rand(size) < 0.3).astype(np.int64)
        scores = (1 / (1 + np.exp(-(rng.randn(size) + 1.5 * labels)))).astype(np.float32)
        out.append((t, scores, labels))
    return out


def _windowed(device, inner):
    metric = pt.AUROC(approx="sketch", num_bins=64, device=device) if inner == "auroc" else pt.Accuracy(device=device)
    return pt.Windowed(metric, window_s=W, num_windows=4, allowed_lateness_s=W)


def _serve(device, inner, deferred, on_card):
    devices = []
    svc = pt.MetricService(_windowed(device, inner), deferred_publish=deferred, queue_size=64,
                           publish_fn=lambda r: devices.append(torch.cuda.current_device()
                                                               if device.type == "cuda" else None))
    with svc._proc_lock:  # a backlog, so spans coalesce
        for i, (t, s, y) in enumerate(_stream()):
            if on_card:
                s, y = torch.from_numpy(s).to(device), torch.from_numpy(y).to(device)
            svc.submit(s, y, event_time=t, seq=i)
    merged = svc.finalize()
    svc.stop()
    return svc, merged, devices


def _assert_same(got, want, rtol):
    assert [r["window"] for r in got] == [r["window"] for r in want]
    for g, w in zip(got, want):
        for key in ("degraded", "final", "watermark", "dropped_samples"):
            assert g[key] == w[key], key
        for key in ("value", "merged"):
            assert isinstance(g[key], np.ndarray)
            np.testing.assert_allclose(g[key], w[key], rtol=rtol, equal_nan=True)


@pytest.mark.cuda
@pytest.mark.parametrize("inner,deferred,on_card", [("auroc", True, True), ("auroc", False, True),
                                                    ("acc", True, False)])
def test_service_on_the_card_equals_the_cpu(cuda, inner, deferred, on_card):
    card, card_merged, devices = _serve(cuda, inner, deferred, on_card)
    host, host_merged, _ = _serve(torch.device("cpu"), inner, deferred, False)
    assert card.metric.device.type == "cuda" and len(card.publications) >= 6
    assert card.coalesced_batches > 0
    _assert_same(card.publications, host.publications, RTOL)
    np.testing.assert_allclose(card_merged.cpu().numpy(), host_merged.numpy(), rtol=RTOL)
    assert set(devices) == {cuda.index or 0}


@pytest.mark.cuda
def test_fleet_store_and_heavy_hitters_on_the_card_equal_the_cpu(cuda):
    stream = _stream(seed=3)
    keys = [f"tenant-{i % 8}" for i in range(len(stream))]
    out = {}
    for device in (cuda, torch.device("cpu")):
        fleet = pt.MetricFleet(lambda device=device: _windowed(device, "acc"), num_shards=4)
        svc = pt.MetricService(_windowed(device, "auroc"), deferred_publish=True)
        store = pt.RetentionStore(ladder=((W, 4), (4 * W, 4))).attach(svc)
        hh = pt.HeavyHitterFleet(lambda device=device: pt.HeavyHitters(pt.Accuracy(device=device), num_hot_slots=4,
                                                                       tail=(4, 256)), num_shards=2)
        for i, ((t, s, y), key) in enumerate(zip(stream, keys)):
            fleet.submit(key, s, (s > 0.5).astype(np.int64), event_time=t)
            svc.submit(torch.from_numpy(s).to(device), torch.from_numpy(y).to(device), event_time=t, seq=i)
            hh.submit([f"k{j % 5}" for j in range(i, i + 16)], torch.from_numpy(s[:16]).to(device),
                      torch.from_numpy(y[:16]).to(device))
        fleet_merged = fleet.finalize()
        fleet.stop()
        svc.finalize()
        svc.stop()
        out[device.type] = (fleet.merged_records, fleet_merged, store.query(time_range=(0.0, 100.0)),
                            store.latest(), hh.compute_heavy_hitters())
    card, host = out["cuda"], out["cpu"]
    assert [r["window"] for r in card[0]] == [r["window"] for r in host[0]] and card[0]
    for g, w in zip(card[0], host[0]):
        assert (g["rows"], g["shards"], g["final"]) == (w["rows"], w["shards"], w["final"])
        np.testing.assert_array_equal(g["value"], w["value"])
    np.testing.assert_array_equal(card[1].cpu().numpy(), host[1].numpy())
    assert len(card[2]) == len(host[2]) > 0
    for g, w in zip(card[2] + [card[3]], host[2] + [host[3]]):
        assert (g["start_s"], g["windows"], g["final"]) == (w["start_s"], w["windows"], w["final"])
        np.testing.assert_allclose(g["value"], w["value"], rtol=RTOL)
    assert [(r["key"], r["count"], r["exact"]) for r in card[4]] == [(r["key"], r["count"], r["exact"]) for r in host[4]]
