"""The port's ``RetentionStore`` against the JAX package's.

* Ladder validation raises the JAX package's errors for the same bad ladders.
* A store attached to a service (synchronous and deferred stages) over 80
  batches, 20 windows of 10 s, on a ladder of 2 raw windows, 2 buckets of
  20 s and 2 of 40 s (so buckets roll up twice and the last rung evicts):
  ``query`` over several ranges and resolutions, ``latest``, every rung's
  bucket layout, ``evicted_buckets``, ``windows_banked`` and ``rollups`` equal
  the JAX store's, and ``resident_bytes`` counts the banked leaves (the
  port's int64 counts make a bucket larger than the JAX package's int32 ones);
  each point equals a flat merge of the raw partials it covers; a resolution
  finer than a rolled-up bucket raises.
* JAX partials banked by the port's store give the JAX store's query results.
* A ``Windowed(Keyed)`` stream's per-tenant reads equal the JAX store's, and
  a finalize-truncated window reads ``final=False``.

Tolerances: window counts, rows, flags and bytes are equal; values from equal
counts (Accuracy) are equal; MeanSquaredError's float32 sums within rtol 1e-6.
"""
import numpy as np
import pytest

import metrics_tpu as mt
import metrics_tpu_torch as pt
from tests.test_torch_faults import plane_hygiene  # noqa: F401  (autouse)
from tests.test_torch_observability import obs_hygiene  # noqa: F401  (autouse)
from tests.test_torch_serving_service import CPU, RTOL, W, serving_hygiene  # noqa: F401  (autouse)

LADDER = ((10.0, 2), (20.0, 2), (40.0, 2))


def _metric(pkg, inner="acc"):
    kw = {} if pkg is mt else CPU
    if inner == "keyed":
        base = pkg.Keyed(pkg.Accuracy(**kw), num_slots=4)
    elif inner == "mse":
        base = pkg.MeanSquaredError(**kw)
    else:
        base = pkg.Accuracy(**kw)
    return pkg.Windowed(base, window_s=W, num_windows=4, allowed_lateness_s=0.0)


def _stream(n=80, size=8, seed=0, keyed=False, mse=False):
    rng = np.random.RandomState(seed)
    out = []
    for i in range(n):
        p = rng.rand(size).astype(np.float32)
        y = rng.rand(size).astype(np.float32) if mse else rng.randint(0, 2, size).astype(np.int32)
        kw = {"slot": rng.randint(0, 4, size).astype(np.int32)} if keyed else {}
        out.append((np.full(size, i * 2.5), p, y, kw))
    return out


def _drive(pkg, stream, inner="acc", deferred=False, name="svc-ret"):
    """A service with a store attached and a raw-partial tee; returns (store, raw partials, service)."""
    raw = []
    svc = pkg.MetricService(_metric(pkg, inner), name=name, deferred_publish=deferred,
                            partial_publish_fn=lambda record, partial: raw.append(partial))
    store = pkg.RetentionStore(ladder=LADDER, name=f"{name}-store").attach(svc)
    for i, (t, p, y, kw) in enumerate(stream):
        svc.submit(p, y, event_time=t, seq=i, **kw)
    svc.finalize()
    svc.stop()
    return store, raw, svc


def _assert_points_equal(got, want, rtol=RTOL):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in set(w) - {"value"}:
            assert g[key] == w[key], key
        np.testing.assert_allclose(np.asarray(g["value"], np.float64), np.asarray(w["value"], np.float64),
                                   rtol=rtol, equal_nan=True)


_QUERIES = [
    dict(time_range=(0.0, 400.0)),
    dict(time_range=(0.0, 400.0), resolution_s=80.0),
    dict(time_range=(0.0, 400.0), resolution_s=160.0),
    dict(time_range=(180.0, 200.0), resolution_s=10.0),
    dict(time_range=(165.0, 185.0)),
    dict(time_range=(50.0, 50.0)),
]


def _assert_stores_equal(port, ref, rtol=RTOL, tenant=None):
    for q in _QUERIES:
        _assert_points_equal(port.query(tenant=tenant, **q), ref.query(tenant=tenant, **q), rtol=rtol)
    _assert_points_equal([port.latest(tenant=tenant)], [ref.latest(tenant=tenant)], rtol=rtol)
    assert _layout(port) == _layout(ref)
    assert port.resident_bytes() == _banked_bytes(port) > 0
    assert (port.evicted_buckets, port.windows_banked, port.rollups, port.queries) == (
        ref.evicted_buckets, ref.windows_banked, ref.rollups, ref.queries)


def _layout(store):
    """Every rung's buckets: cell, covered span, window count and verdict."""
    (stream,) = store._streams.values()
    return [sorted((cell, b["start_s"], b["end_s"], b["windows"], b["final"]) for cell, b in rung.items())
            for rung in stream.rungs]


def _banked_bytes(store):
    """The banked leaves' bytes, counted here with numpy. The same layout holds
    other bytes in the two packages: the port counts Accuracy's samples in
    int64, the JAX package (without x64) in int32 (ROADMAP section 3)."""
    (stream,) = store._streams.values()
    total = 0
    for rung in stream.rungs:
        for b in rung.values():
            leaves = [getattr(v, "counts", v) for v in b["state"].values()] + [b["rows"]]
            total += sum(np.asarray(leaf).nbytes for leaf in leaves)
    return total


@pytest.mark.parametrize("ladder", [
    [], [(10.0, 0)], [(0.0, 4)], [(10.0, 4), (15.0, 4)], [(10.0, 4), (10.0, 4)], [(10.0, 4), (40.0, 1.5)],
])
def test_ladder_validation_raises_the_jax_errors(ladder):
    with pytest.raises(ValueError) as want:
        mt.RetentionStore(ladder=ladder)
    with pytest.raises(ValueError) as got:
        pt.RetentionStore(ladder=ladder)
    assert str(got.value) == str(want.value)
    svc = pt.MetricService(_metric(pt))
    with pytest.raises(ValueError, match="rung 0 must be"):
        pt.RetentionStore(ladder=((20.0, 4),)).attach(svc)
    with pytest.raises(ValueError, match="MetricService or a MetricFleet"):
        pt.RetentionStore().attach(object())


@pytest.mark.parametrize("inner,deferred", [("acc", False), ("acc", True), ("mse", True)])
def test_queries_and_gauges_equal_jax(inner, deferred):
    stream = _stream(mse=inner == "mse")
    port, raw, _ = _drive(pt, stream, inner, deferred)
    ref, _, _ = _drive(mt, stream, inner, deferred)
    assert port.rollups > 0 and port.evicted_buckets > 0 and port.windows_banked == 20
    _assert_stores_equal(port, ref)
    # every point is the flat merge of the raw partials it covers (merge first, finish once)
    template = _metric(pt, inner)
    for point in port.query(time_range=(0.0, 400.0), resolution_s=80.0):
        lo, hi = point["start_s"], point["start_s"] + point["seconds"]
        covered = [p for p in raw if lo <= p["window_start_s"] < hi]
        if point["windows"] == len(covered):  # buckets still resident (the evicted ones are gone)
            # bit-equal for integer counts; float32 sums fold in another order (rtol)
            np.testing.assert_allclose(point["value"], np.asarray(template.value_from_partials(covered)),
                                       rtol=RTOL if inner == "mse" else 0.0)
    with pytest.raises(ValueError, match="cannot split"):
        port.query(time_range=(0.0, 400.0), resolution_s=10.0)
    with pytest.raises(ValueError, match="precedes"):
        port.query(time_range=(10.0, 0.0))
    with pytest.raises(ValueError, match="no tenant axis"):
        port.query(time_range=(0.0, 400.0), tenant=0)


def test_jax_partials_banked_by_the_port_store_query_as_the_jax_store():
    stream = _stream(seed=3)
    ref, jax_raw, jsvc = _drive(mt, stream)
    host = pt.MetricService(_metric(pt), name=jsvc.label)  # the port stream the JAX partials bank under
    port = pt.RetentionStore(ladder=LADDER, name=ref.label).attach(host)
    for partial in jax_raw:
        port.ingest(jsvc.label, partial)
    port.queries = ref.queries  # the gauge counts reads; the JAX store was read by nothing else
    _assert_stores_equal(port, ref)
    with pytest.raises(KeyError):
        port.ingest("no-such-stream", jax_raw[0])


def test_keyed_tenant_reads_and_truncated_final_equal_jax():
    stream = _stream(n=30, keyed=True, seed=5)
    port, _, _ = _drive(pt, stream, "keyed", deferred=True, name="svc-keyed")
    ref, _, _ = _drive(mt, stream, "keyed", deferred=True, name="svc-keyed")
    for tenant in (None, 0, 3):
        _assert_points_equal(port.query(time_range=(0.0, 80.0), tenant=tenant),
                             ref.query(time_range=(0.0, 80.0), tenant=tenant))
    latest = port.latest()
    assert latest["value"].shape == (4,) and latest["final"] is False  # finalize flushed the open head window
    assert [p["final"] for p in port.query(time_range=(0.0, 80.0))][-1] is False
    with pytest.raises(KeyError, match="out of range"):
        port.query(time_range=(0.0, 80.0), tenant=4)


def test_attach_composes_with_an_installed_tap_and_reingest_replaces():
    seen = []
    svc = pt.MetricService(_metric(pt), name="svc-compose", deferred_publish=False,
                           partial_publish_fn=lambda record, partial: seen.append(record["window"]))
    store = pt.RetentionStore(ladder=LADDER).attach(svc)
    with pytest.raises(ValueError, match="already retained"):
        store.attach(svc)
    for i, (t, p, y, _) in enumerate(_stream(n=12)):
        svc.submit(p, y, event_time=t, seq=i)
    svc.flush()
    assert seen and store.windows_banked == len(seen)
    partial = svc.metric.window_partial(svc.metric.resident_windows()[-1])
    before = len(store.query(time_range=(0.0, 400.0)))
    store.ingest(svc.label, partial)
    store.ingest(svc.label, partial)  # a re-published window replaces its bucket
    assert len(store.query(time_range=(0.0, 400.0))) == before + 1
