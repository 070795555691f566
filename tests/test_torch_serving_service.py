"""The port's serving loop (``metrics_tpu_torch.serving.service``) against the JAX package.

The same seeded numpy stream (batches of 8-48 events, 12-40 batches) goes
through ``metrics_tpu.MetricService`` and ``metrics_tpu_torch.MetricService``
(metrics built with ``device="cpu"``), each over a ``Windowed`` ring whose
merged view syncs through a one-process gather (the JAX package's
``gather_all_arrays``, the port's ``packable_gather(lambda v: [v])``), so every
publish runs the guarded sync:

* every publication record, in order, for the clean stream, the synchronous
  stage, ``drop_oldest`` with its shed counter, a late burst, clock skew, an
  ingest stall, a persistent sync drop that degrades every publish, and a
  mid-window preempt followed by ``restore`` and an overlap replay (held to
  the run that was not interrupted as well);
* the deferred stage equals the synchronous stage; coalescing on equals
  coalescing off over ``tests/serving/test_ingest_coalesce.py``'s bursty
  stream (tumbling, sliding, keyed), and both equal the JAX package's;
* ``last_snapshot`` has the JAX package's keys, and a JAX ``last_snapshot``
  restored into the port's service resumes to the JAX service's records;
* ``Metric.state_dict`` is a copy on the CPU: an array, list, buffer, sketch
  and window-slab state's snapshot is unchanged by a later ``update`` and
  loads into both packages (the alias it repairs is ROADMAP section 3).

Every test stops each service, fleet and ``ExpositionServer`` of both packages
it made, even when it fails, drains both host planes, and fails if a service
worker or a server thread is left alive (``serving_hygiene``; the other serving
test files import it). No test reads a wall time.

Tolerances: window ids, counts, drop / shed / replay counts, ``degraded`` and
``final`` and record keys are equal; float values within rtol 1e-6 (float32
ratios and sums of the same counts; the sketch curves rtol 1e-5, as in
``test_torch_windowed.py``).
"""
import copy
import threading
import time
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt
import metrics_tpu.observability.compilemon as jcompilemon
import metrics_tpu.observability.counters as jcounters
import metrics_tpu.observability.devtime as jdevtime
import metrics_tpu.observability.lifecycle as jlifecycle
import metrics_tpu.observability.trace as jtrace
import metrics_tpu.serving as jserving
import metrics_tpu_torch as pt
import metrics_tpu_torch.observability as pobs
import metrics_tpu_torch.serving as pserving
from metrics_tpu.parallel import deferred as jdeferred
from metrics_tpu.parallel import faults as jfaults
from metrics_tpu.parallel.sync import SyncGuard as JSyncGuard
from metrics_tpu.parallel.sync import gather_all_arrays
from metrics_tpu.utils.exceptions import PreemptionError as JPreemptionError
from metrics_tpu_torch.parallel import deferred as pdeferred
from metrics_tpu_torch.parallel import faults as pfaults
from metrics_tpu_torch.parallel import sync as psync
from metrics_tpu_torch.serving.service import INGEST_SITE, ServiceStoppedError
from metrics_tpu_torch.utils.exceptions import PreemptionError
from tests.serving.test_ingest_coalesce import _bursty_batches
from tests.test_torch_faults import plane_hygiene  # noqa: F401  (autouse)
from tests.test_torch_observability import obs_hygiene  # noqa: F401  (autouse)

torch.set_num_threads(1)

RTOL, RTOL_SKETCH = 1e-6, 1e-5
CPU = {"device": "cpu"}
W = 10.0

_SERVICES = (jserving.MetricService, pserving.MetricService)
_FLEETS = (jserving.MetricFleet, pserving.MetricFleet)
_SERVERS = (jserving.ExpositionServer, pserving.ExpositionServer)
_SERVER_THREADS = ("metrics-tpu-exposition", "mtpu-torch-exposition")
_JAX_OBS = (jtrace, jcounters, jlifecycle, jcompilemon, jdevtime)


@pytest.fixture(autouse=True)
def serving_hygiene(plane_hygiene, obs_hygiene, monkeypatch):  # noqa: F811
    """Runs each test with the JAX package's observability off (restored after),
    records every service, fleet and exposition server of both packages the
    test builds, and afterwards stops and closes them all (even when the test
    failed), drains both host planes and asserts that no service worker and no
    server thread is alive. Tears down before ``plane_hygiene`` and
    ``obs_hygiene`` check the planes."""
    jax_on = [mod.is_enabled() for mod in _JAX_OBS]
    for mod in _JAX_OBS:
        mod.disable()
    made = []
    for cls in (*_SERVICES, *_FLEETS, *_SERVERS):
        original = cls.__init__

        def init(self, *args, _original=original, **kwargs):
            _original(self, *args, **kwargs)
            made.append(self)

        monkeypatch.setattr(cls, "__init__", init)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield made
    monkeypatch.undo()
    for obj in reversed(made):
        try:
            if isinstance(obj, _SERVERS):
                obj.close()
            else:
                obj.stop(10.0)
        except BaseException:  # noqa: BLE001 - a failed test's object still has to stop
            pass
    pdeferred.drain_host_plane()
    jdeferred.drain_host_plane()
    problems = []
    for thread in threading.enumerate():
        if thread.name.startswith("mtpu-service-") or thread.name in _SERVER_THREADS:
            thread.join(5.0)
            if thread.is_alive():
                problems.append(f"thread {thread.name} still alive")
    for mod, on in zip(_JAX_OBS, jax_on):
        (mod.enable if on else mod.disable)()
    assert not problems, problems


# ------------------------------------------------------------------ builders
def _inner(pkg, kind):
    kw = {} if pkg is mt else CPU
    if kind == "acc":
        return pkg.Accuracy(**kw)
    if kind == "mse":
        return pkg.MeanSquaredError(**kw)
    if kind == "auroc":
        return pkg.AUROC(approx="sketch", num_bins=16, **kw)
    if kind == "keyed":
        return pkg.Keyed(pkg.Accuracy(**kw), num_slots=8)
    raise ValueError(kind)


def one_process_gather(pkg):
    """A world of one: the gather every publish-time sync runs through."""
    return gather_all_arrays if pkg is mt else psync.packable_gather(lambda v: [v])


def windowed(pkg, inner="acc", sync=True, **kw):
    args = dict(window_s=W, num_windows=4, allowed_lateness_s=W)
    args.update(kw)
    if sync:
        args["dist_sync_fn"] = one_process_gather(pkg)
    return pkg.Windowed(_inner(pkg, inner), **args)


def to_pkg(pkg, x):
    return jnp.asarray(x) if pkg is mt else torch.from_numpy(np.ascontiguousarray(x))


def batches(n=12, size=8, seed=0):
    rng = np.random.RandomState(seed)
    return [(i * 5.0 + rng.uniform(0.0, 5.0, size), rng.rand(size).astype(np.float32),
             rng.randint(0, 2, size).astype(np.int32)) for i in range(n)]


def feed(pkg, svc, stream, start=0):
    for i, (t, p, y) in enumerate(stream[start:], start=start):
        svc.submit(to_pkg(pkg, p), to_pkg(pkg, y), event_time=t, seq=i)


def summary(svc, merged=None):
    return {
        "publications": list(svc.publications),
        "merged": None if merged is None else np.asarray(merged),
        "processed": svc.processed,
        "shed": svc.shed_events,
        "replayed": svc.replayed_steps,
        "dropped": svc.metric.dropped_samples,
        "health": svc.health,
        "state": svc.state,
    }


def assert_records_equal(got, want, rtol=RTOL, skip=("service",)):
    """Records of the port against the JAX package's: the same keys, equal
    ids, counts and flags, float values within ``rtol``."""
    assert [r["window"] for r in got] == [r["window"] for r in want]
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for key in w:
            if key in skip:
                continue
            a, b = g[key], w[key]
            if isinstance(a, np.ndarray) or isinstance(b, (np.ndarray, jnp.ndarray)):
                np.testing.assert_allclose(np.asarray(a, np.float64), np.asarray(b, np.float64), rtol=rtol,
                                           equal_nan=True, err_msg=f"window {w['window']} {key}")
            else:
                assert a == b, (w["window"], key, a, b)


def assert_summaries_equal(got, want, rtol=RTOL):
    assert_records_equal(got["publications"], want["publications"], rtol=rtol)
    if want["merged"] is not None:
        np.testing.assert_allclose(got["merged"], want["merged"], rtol=rtol, equal_nan=True)
    for key in ("processed", "shed", "replayed", "dropped", "health", "state"):
        assert got[key] == want[key], key


# ------------------------------------------------------ the state_dict repair
def _persistent(metric):
    metric.persistent(True)  # checkpoint every state, as a serving snapshot does
    return metric


_SNAPSHOT_KINDS = {
    "array": lambda pkg, kw: _persistent(pkg.MeanSquaredError(**kw)),
    "list": lambda pkg, kw: _persistent(pkg.AUROC(**kw)),
    "buffer": lambda pkg, kw: _persistent(pkg.AUROC(capacity=256, **kw)),
    "sketch": lambda pkg, kw: _persistent(pkg.AUROC(approx="sketch", num_bins=16, **kw)),
    "slab": lambda pkg, kw: pkg.Windowed(pkg.MeanSquaredError(**kw), window_s=W, num_windows=2),
}


def _snapshot_batch(kind, seed):
    rng = np.random.RandomState(seed)
    p = rng.rand(32).astype(np.float32)
    y = rng.randint(0, 2, 32).astype(np.int32) if kind in ("list", "buffer", "sketch") else rng.rand(32).astype(
        np.float32)
    return p, y


def _snapshot_update(pkg, metric, kind, seed):
    p, y = _snapshot_batch(kind, seed)
    kw = {"event_time": np.full(32, 1.0 + seed)} if kind == "slab" else {}
    metric.update(to_pkg(pkg, p), to_pkg(pkg, y), **kw)


def _frozen(tree):
    return copy.deepcopy(tree)


def _tree_equal(a, b):
    if isinstance(a, dict):
        return set(a) == set(b) and all(_tree_equal(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_tree_equal(x, y) for x, y in zip(a, b))
    return np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True)


@pytest.mark.parametrize("kind", sorted(_SNAPSHOT_KINDS))
def test_state_dict_snapshot_is_isolated_from_later_updates(kind):
    make = _SNAPSHOT_KINDS[kind]
    port = make(pt, CPU)
    _snapshot_update(pt, port, kind, 0)
    snap = port.state_dict()
    frozen = _frozen(snap)
    _snapshot_update(pt, port, kind, 1)  # the planes update CPU states in place
    assert _tree_equal(snap, frozen), "a later update changed an earlier state_dict"
    # the snapshot loads into both packages (over a metric that saw other data:
    # loading replaces the state) and resumes the first update's value
    want = make(pt, CPU)
    _snapshot_update(pt, want, kind, 0)
    resumed, ref = make(pt, CPU), make(mt, {})
    _snapshot_update(pt, resumed, kind, 2)
    _snapshot_update(mt, ref, kind, 2)
    resumed.load_state_dict(snap)
    ref.load_state_dict(snap)
    rtol = RTOL_SKETCH if kind == "sketch" else RTOL
    np.testing.assert_allclose(np.asarray(resumed.compute()), np.asarray(want.compute()), rtol=rtol)
    np.testing.assert_allclose(np.asarray(ref.compute()), np.asarray(want.compute()), rtol=rtol)


def test_window_partial_is_isolated_from_the_ring_roll():
    m = windowed(pt, "mse", sync=False, num_windows=2, allowed_lateness_s=0.0)
    m.update(torch.ones(4), torch.zeros(4), event_time=np.full(4, 1.0))
    partial = m.window_partial(0)
    frozen = _frozen(partial)
    m.update(torch.full((4,), 3.0), torch.zeros(4), event_time=np.full(4, 25.0))  # recycles window 0's slot
    assert _tree_equal(partial, frozen)


# ----------------------------------------------------------------- lifecycle
def test_lifecycle_constructor_errors_and_stop_equal_jax():
    for pkg in (mt, pt):
        with pytest.raises(ValueError, match="Windowed"):
            pkg.MetricService(_inner(pkg, "acc"))
        with pytest.raises(ValueError, match="window roll"):
            pkg.MetricService(pkg.Windowed(_inner(pkg, "acc"), decay_half_life_s=5.0))
        with pytest.raises(ValueError, match="shed_policy"):
            pkg.MetricService(windowed(pkg), shed_policy="tail_drop")
        with pytest.raises(ValueError, match="queue_size"):
            pkg.MetricService(windowed(pkg), queue_size=0)
        with pytest.raises(ValueError, match="coalesce_max_batches"):
            pkg.MetricService(windowed(pkg), coalesce_max_batches=0)
    svc = pt.MetricService(windowed(pt))
    with pytest.raises(ValueError, match="event_time"):
        svc.submit(torch.tensor([0.5]))
    feed(pt, svc, batches(4))
    svc.flush()
    assert svc.processed == 4 and svc.state == "running"
    svc.stop()
    assert svc.state == "stopped"
    svc.stop()  # idempotent
    with pytest.raises(ServiceStoppedError):
        svc.submit(torch.tensor([0.5]), torch.tensor([1]), event_time=np.array([1.0]))
    assert set(pserving.HEALTH_STATES) == set(jserving.HEALTH_STATES) and INGEST_SITE == "service.ingest"


def _run_pair(scenario, stream, service_kw=None, metric_kw=None, chaos=None):
    """One scenario through both packages: ``(port summary, JAX summary)``."""
    out = {}
    for pkg in (mt, pt):
        faults = jfaults if pkg is mt else pfaults
        kw = dict(service_kw or {})
        if "guard" in kw:
            kw["guard"] = (JSyncGuard if pkg is mt else psync.SyncGuard)(**kw["guard"])
        injector = faults.ChaosInjector([faults.FaultSpec(**spec) for spec in chaos], seed=0) if chaos else None
        if injector is not None:
            injector.install()
        try:
            svc = pkg.MetricService(windowed(pkg, **(metric_kw or {})), name=f"svc-{scenario}", **kw)
            feed(pkg, svc, stream)
            svc.flush()
            merged = svc.finalize()
            svc.stop()
        finally:
            if injector is not None:
                injector.uninstall()
        out[pkg] = summary(svc, merged)
        if injector is not None:
            out[pkg]["injected"] = {k: v for k, v in injector.injected.items() if v}
    return out[pt], out[mt]


_SCENARIOS = {
    "clean": dict(),
    "synchronous": dict(service_kw={"deferred_publish": False}),
    "late_burst": dict(chaos=[dict(kind="late_burst", call=3, times=1, skew_s=50.0, site=INGEST_SITE)]),
    "clock_skew": dict(chaos=[dict(kind="clock_skew", call=1, times=1, skew_s=100.0, site=INGEST_SITE)]),
    "ingest_stall": dict(chaos=[dict(kind="ingest_stall", call=0, times=1, duration_s=0.05, site=INGEST_SITE)]),
    "persistent_drop": dict(
        chaos=[dict(kind="drop", rate=1.0, times=10_000, site="host_gather")],
        service_kw={"guard": dict(deadline_s=1.0, max_retries=1, backoff_s=0.01, policy="degrade")}),
    "keyed": dict(metric_kw={"inner": "keyed"}),
    "sketch": dict(metric_kw={"inner": "auroc"}),
}


@pytest.mark.parametrize("scenario", sorted(_SCENARIOS))
def test_publications_equal_jax(scenario):
    spec = _SCENARIOS[scenario]
    stream = batches(12, seed=4)
    if scenario == "keyed":
        rng = np.random.RandomState(9)
        stream = [(t, p, y, rng.randint(0, 8, p.size)) for t, p, y in stream]
    port, ref = _run_pair(scenario, stream, **spec) if scenario != "keyed" else _run_keyed(stream)
    rtol = RTOL_SKETCH if scenario == "sketch" else RTOL
    assert_summaries_equal(port, ref, rtol=rtol)
    assert len(port["publications"]) >= 4
    assert port.get("injected") == ref.get("injected")
    if scenario == "persistent_drop":
        assert all(r["degraded"] for r in port["publications"]) and port["health"] == "degraded"
    else:
        assert not any(r["degraded"] for r in port["publications"]) and port["health"] == "healthy"
    if scenario == "late_burst":
        assert port["dropped"] == stream[3][0].size
    if scenario == "clock_skew":
        assert port["publications"][-1]["watermark"] > 100.0


def _run_keyed(stream):
    out = {}
    for pkg in (mt, pt):
        svc = pkg.MetricService(windowed(pkg, "keyed"), name="svc-keyed")
        for i, (t, p, y, slot) in enumerate(stream):
            svc.submit(to_pkg(pkg, p), to_pkg(pkg, y), event_time=t, seq=i, slot=to_pkg(pkg, slot.astype(np.int32)))
        merged = svc.finalize()
        svc.stop()
        out[pkg] = summary(svc, merged)
    return out[pt], out[mt]


def test_drop_oldest_sheds_the_same_batches_as_jax():
    """A deterministic shed: the worker holds one batch while the test owns the
    processing lock, so the 2-deep queue takes two and sheds the rest's oldest."""
    stream = batches(5, seed=2)
    out = {}
    for pkg in (mt, pt):
        svc = pkg.MetricService(windowed(pkg), queue_size=2, shed_policy="drop_oldest", name="svc-shed")
        feed(pkg, svc, stream[:1])
        _wait_empty(svc)
        with svc._proc_lock:
            feed(pkg, svc, stream[1:2])
            _wait_empty(svc)
            feed(pkg, svc, stream[2:])
            assert svc.health == "shedding"
        merged = svc.finalize()
        svc.stop()
        out[pkg] = summary(svc, merged)
    # batch 0 applied, batch 1 in the worker's hand, batches 2-4 into a 2-deep queue: batch 2 is shed
    assert out[pt]["shed"] == 1 and out[pt]["processed"] == 4
    assert_summaries_equal(out[pt], out[mt])
    assert pobs.counters_snapshot()["service_health"]["svc-shed"]["shed_events"] == 1


def _wait_empty(svc, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while svc._queue.qsize() > 0 and time.monotonic() < deadline:
        time.sleep(0.005)
    assert svc._queue.qsize() == 0


def test_block_policy_never_sheds():
    svc = pt.MetricService(windowed(pt), queue_size=2, shed_policy="block")
    feed(pt, svc, batches(6))
    svc.flush()
    assert svc.shed_events == 0 and svc.processed == 6


# --------------------------------------------- preempt, restore and replay
def _preempted(pkg, stream, call=6):
    faults = jfaults if pkg is mt else pfaults
    with faults.ChaosInjector([faults.FaultSpec(kind="preempt", call=call, times=1, site=INGEST_SITE)], seed=0):
        svc = pkg.MetricService(windowed(pkg), name="svc-preempt")
        with pytest.raises((ServiceStoppedError, PreemptionError, JPreemptionError, jserving.ServiceStoppedError)):
            feed(pkg, svc, stream)
            svc.flush()
        assert svc.state == "preempted"
        snap = svc.snapshot()
        early = list(svc.publications)
        svc.stop()
    return snap, early


def test_preempt_restore_and_overlap_replay_equal_the_uninterrupted_run_and_jax():
    stream = batches(12, seed=3)
    got = {}
    for pkg in (mt, pt):
        plain = pkg.MetricService(windowed(pkg), name="svc-plain")
        feed(pkg, plain, stream)
        truth = summary(plain, plain.finalize())
        plain.stop()
        snap, early = _preempted(pkg, stream)
        assert snap["processed"] == 6  # the batch in flight was not applied
        restored = pkg.MetricService(windowed(pkg), name="svc-restored")
        restored.restore(snap)
        feed(pkg, restored, stream, start=4)  # from before the snapshot: folded steps no-op
        resumed = summary(restored, restored.finalize())
        restored.stop()
        published = early + resumed["publications"]
        assert [r["window"] for r in published] == [r["window"] for r in truth["publications"]]  # none lost or twice
        assert_records_equal([{k: r[k] for k in ("window", "value", "final")} for r in published],
                             [{k: r[k] for k in ("window", "value", "final")} for r in truth["publications"]])
        np.testing.assert_array_equal(resumed["merged"], truth["merged"])
        assert resumed["dropped"] == truth["dropped"] and resumed["replayed"] == 2
        got[pkg] = (early, resumed, sorted(snap), sorted(snap["metric"]))
    assert_records_equal(got[pt][0], got[mt][0])
    assert_summaries_equal(got[pt][1], got[mt][1])
    assert got[pt][2:] == got[mt][2:]


def test_jax_last_snapshot_restores_into_the_port_service():
    stream = batches(12, seed=6)
    jsvc = mt.MetricService(windowed(mt), name="svc-j")
    feed(mt, jsvc, stream[:7])
    jsvc.flush()
    snap = jsvc.last_snapshot
    jsvc.stop()
    assert snap is not None and snap["published_through"] is not None
    psvc = pt.MetricService(windowed(pt), name="svc-p")
    psvc.flush()
    assert psvc.last_snapshot is None
    feed(pt, psvc, stream[:7])
    psvc.flush()
    assert sorted(psvc.last_snapshot) == sorted(snap)
    assert sorted(psvc.last_snapshot["metric"]) == sorted(snap["metric"])
    psvc.stop()
    out = {}
    for pkg in (mt, pt):
        svc = pkg.MetricService(windowed(pkg), name="svc-resumed")
        svc.restore(snap)
        feed(pkg, svc, stream, start=snap["processed"] - 1)  # one step of overlap
        out[pkg] = summary(svc, svc.finalize())
        svc.stop()
    assert out[pt]["replayed"] == 1
    assert_summaries_equal(out[pt], out[mt])


def test_replayed_steps_count_every_watermark_noop():
    stream = batches(6)
    svc = pt.MetricService(windowed(pt))
    feed(pt, svc, stream)
    svc.flush()
    restored = pt.MetricService(windowed(pt))
    restored.restore(svc.snapshot())
    feed(pt, restored, stream)
    restored.flush()
    assert restored.replayed_steps == len(stream)


def test_watermark_jump_publishes_expiring_windows_before_the_roll():
    rng = np.random.RandomState(11)
    svc = pt.MetricService(windowed(pt))
    for base in (2.0, 12.0, 85.0):
        svc.submit(torch.from_numpy(rng.rand(4).astype(np.float32)),
                   torch.from_numpy(rng.randint(0, 2, 4).astype(np.int32)), event_time=np.full(4, base))
        svc.flush()
        if base == 12.0:
            assert svc.publications == []
    assert [p["window"] for p in svc.publications][:2] == [0, 1]
    assert all(not np.isnan(float(p["value"])) for p in svc.publications[:2])


# ------------------------------------------------------ deferred, coalescing
def test_deferred_stage_equals_synchronous_stage():
    stream = batches(16, seed=4)
    runs = {}
    for deferred in (False, True):
        svc = pt.MetricService(windowed(pt, "auroc"), deferred_publish=deferred, name=f"svc-{deferred}")
        feed(pt, svc, stream)
        runs[deferred] = summary(svc, svc.finalize())
        svc.stop()
    assert_summaries_equal(runs[True], runs[False], rtol=0.0)
    assert len(runs[True]["publications"]) >= 4


def _coalesce_metric(pkg, shape):
    if shape == "sliding":
        return windowed(pkg, sync=False, num_windows=8, slide_s=5.0)
    return windowed(pkg, "keyed" if shape == "keyed" else "acc", sync=False)


def _drive_coalesced(pkg, shape, stream, coalesce):
    svc = pkg.MetricService(_coalesce_metric(pkg, shape), queue_size=len(stream) + 4,
                            coalesce_max_batches=8 if coalesce else 1, name=f"svc-{shape}")
    with svc._proc_lock:  # the backlog the drain coalesces
        for i, (t, p, y, kw) in enumerate(stream):
            kw = {k: to_pkg(pkg, v.astype(np.int32)) for k, v in kw.items()}
            svc.submit(to_pkg(pkg, p), to_pkg(pkg, y), event_time=t, seq=i, **kw)
    out = summary(svc, svc.finalize())
    out["coalesced"], out["drains"] = svc.coalesced_batches, svc.drains
    svc.stop()
    return out


@pytest.mark.parametrize("shape", ["tumbling", "sliding", "keyed"])
def test_coalescing_on_equals_off_and_jax(shape):
    stream = _bursty_batches(n=40, keyed=shape == "keyed")
    on = _drive_coalesced(pt, shape, stream, True)
    off = _drive_coalesced(pt, shape, stream, False)
    ref = _drive_coalesced(mt, shape, stream, True)
    assert off["coalesced"] == 0 and on["coalesced"] > 0 and on["drains"] < off["drains"]
    assert len(on["publications"]) > 2
    assert_summaries_equal(on, off, rtol=0.0)
    assert_summaries_equal(on, ref)  # how many batches a drain takes depends on thread timing: not compared


# ---------------------------------------------------- gauges, spans, labels
def test_health_gauge_labels_and_publish_spans():
    a, b = pt.MetricService(windowed(pt)), pt.MetricService(windowed(pt))
    assert a.label != b.label and a.label.startswith("MetricService(Accuracy)#")
    snap = pobs.counters_snapshot()["service_health"]
    assert a.label in snap and b.label in snap
    a.stop()
    b.stop()
    pobs.enable()
    svc = pt.MetricService(windowed(pt), name="svc-spans")
    feed(pt, svc, batches(10, seed=6))
    svc.flush()
    svc.finalize()
    svc.stop()
    published = [p["window"] for p in svc.publications]
    spans = [r for r in pobs.records() if r.name == "service.publish"]
    assert [s.attrs["window"] for s in spans] == published
    assert all(s.attrs["service"] == "svc-spans" and s.attrs["deferred"] == "yes" and s.attrs["degraded"] == "no"
               and isinstance(s.attrs["queue_depth"], int) for s in spans)
    snap = pobs.counters_snapshot()
    assert snap["service_health"]["svc-spans"]["published"] == len(published)
    assert snap["deferred_depth"]["svc-spans"]["current"] == 0
    assert snap["lifecycle"]["svc-spans"]["windows_stamped"] == len(published)
    assert all(isinstance(p["flow"], int) for p in svc.publications)
    assert "svc-spans" in snap["watermark_lag"]


def test_exports_equal_jax():
    assert set(pserving.__all__) == set(jserving.__all__)
    for name in pserving.__all__:
        assert hasattr(pserving, name), name
    for name in ("MetricService", "MetricFleet", "RetentionStore", "HeavyHitterFleet", "ExpositionServer"):
        assert getattr(pt, name) is getattr(pserving, name) and name in pt.__all__ and hasattr(mt, name)
    import metrics_tpu_torch.serving.service as pservice
    import metrics_tpu.serving.service as jservice
    assert set(pservice.__all__) == set(jservice.__all__)
