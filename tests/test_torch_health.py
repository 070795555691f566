"""The health planes of the port, against the JAX package.

* The lifecycle ledger: the same explicit ``ns`` stamps (first-wins and
  last-wins stages, a duplicate close, a window that never publishes, merge
  and bank stamps) give the same ledgers, per-stage latencies and derived
  gauges (``lifecycle`` and ``selfmeter`` blocks, the staleness keys) as the
  JAX ``LEDGER``; the ledger is bounded (FIFO eviction at ``LEDGER_CAP``) and
  records nothing while disabled.
* ``Windowed``'s ``first_event`` / ``last_event`` stamps with
  ``lifecycle_label`` set: the same windows as the JAX package's on the same
  seeded streams (ring and sliding), none without a label.
* ``LatencyMeter``: bucket indices, quantiles, ``error_bound``, summaries and
  merges bit-equal to the JAX meter on 10,000 seeded lognormal latencies
  (with zero-bucket and overflow values); ``merge_meters``; grid errors.
* ``check_trajectory`` / ``load_rounds``: the same verdicts as the JAX gate on
  synthetic rounds written into ``tmp_path`` (regression, improvement,
  collapse, faults, unreadable rounds).
* ``time_fn`` / ``profile_metric``: the JAX package's keys, positive times.

Tolerances: every compared value is equal (floats bit for bit: the same
arithmetic on the same float64 inputs).
"""
import json

import numpy as np
import pytest
import torch

import metrics_tpu as mt
import metrics_tpu.observability as jobs
import metrics_tpu_torch as pt
import metrics_tpu_torch.observability as pobs
from metrics_tpu.observability import lifecycle as jlifecycle
from metrics_tpu.observability import regress as jregress
from metrics_tpu.observability import selfmeter as jselfmeter
from metrics_tpu_torch.observability import lifecycle as plifecycle
from metrics_tpu_torch.observability import regress as pregress
from metrics_tpu_torch.observability import selfmeter as pselfmeter
from tests.test_torch_faults import plane_hygiene  # noqa: F401  (autouse: every test leaves the process clean)
from tests.test_torch_observability import obs_hygiene  # noqa: F401  (autouse: observability off and empty)

torch.set_num_threads(1)
CPU = {"device": "cpu"}


@pytest.fixture()
def both_enabled():
    """Both packages' observability on for one test, off and empty before and
    after it (an earlier JAX test on this worker may have left ledger entries)."""
    jobs.disable()
    jobs.reset()
    pobs.enable()
    jobs.enable()
    try:
        yield
    finally:
        jobs.disable()
        jobs.reset()


_STAMPS = [  # (label, window, stage, ns)
    ("svc", 0, "first_event", 1_000_000),
    ("svc", 0, "last_event", 3_000_000),
    ("svc", 1, "first_event", 2_500_000),
    ("svc", 0, "last_event", 4_000_000),  # last wins
    ("svc", 0, "first_event", 9_000_000),  # first wins: ignored
    ("svc", 0, "closed", 6_000_000),
    ("svc", 0, "closed", 7_000_000),  # a duplicate close: ignored
    ("svc", 0, "sync_started", 6_500_000),
    ("svc", 0, "sync_done", 8_250_000),
    ("svc", 0, "published", 9_125_000),
    ("svc", 1, "last_event", 5_000_000),
    ("svc", 1, "closed", 12_000_000),
    ("svc", 1, "published", 15_000_000),  # a partial ledger: no sync stamps
    ("svc", 0, "merged", 11_000_000),
    ("svc", 0, "banked", 13_500_000),
    ("svc", 1, "banked", 16_000_000),  # banked without merged: measured from published
    ("other", 7, "first_event", 100),
]


def _stamp_all(lifecycle_mod):
    for label, window, stage, ns in _STAMPS:
        lifecycle_mod.stamp(label, window, stage, ns=ns)


def test_ledger_and_derived_gauges_equal_jax(both_enabled):
    _stamp_all(plifecycle)
    _stamp_all(jlifecycle)
    assert pobs.LEDGER.ledgers() == jobs.LEDGER.ledgers()
    for label, window in (("svc", 0), ("svc", 1), ("other", 7), ("svc", 99)):
        assert pobs.LEDGER.latencies(label, window) == jobs.LEDGER.latencies(label, window)
        assert pobs.LEDGER.entry(label, window) == jobs.LEDGER.entry(label, window)
    got, want = pobs.counters_snapshot(), jobs.counters_snapshot()
    assert got["lifecycle"] == want["lifecycle"] == {"svc": {"windows_stamped": 1, "open_windows": 0,
                                                             "e2e_ms": 3.0}}
    assert got["selfmeter"] == want["selfmeter"]
    assert set(got["selfmeter"]["svc"]) == {"ingest", "close", "dispatch", "sync", "publish", "e2e", "merge", "bank"}
    assert got["publish_staleness"].keys() == want["publish_staleness"].keys() == {"svc"}
    assert {k: m.counts.tolist() for k, m in pselfmeter.SELFMETER.meters().items()} == \
        {k: m.counts.tolist() for k, m in jselfmeter.SELFMETER.meters().items()}
    assert pobs.STAGES == jobs.STAGES and plifecycle.STAGE_SPANS == jlifecycle.STAGE_SPANS
    with pytest.raises(ValueError, match="unknown lifecycle stage"):
        pobs.LEDGER.stamp("svc", 0, "nope")


def test_ledger_is_bounded_fifo_and_off_while_disabled(monkeypatch):
    plifecycle.stamp("svc", 0, "first_event", ns=1)  # disabled: nothing
    assert pobs.LEDGER.ledgers() == {}
    pobs.enable()
    monkeypatch.setattr(plifecycle, "LEDGER_CAP", 4)
    for w in range(6):
        plifecycle.stamp("svc", w, "first_event", ns=w)
    assert sorted(pobs.LEDGER.ledgers("svc")) == [2, 3, 4, 5]  # the two oldest evicted
    plifecycle.stamp("svc", 3, "last_event", ns=10)  # an existing entry: nothing evicted
    assert sorted(pobs.LEDGER.ledgers("svc")) == [2, 3, 4, 5]
    assert pobs.next_flow_id() < pobs.next_flow_id()


def _window_stream(seed, steps=6, n=40, stride=10.0):
    rng = np.random.RandomState(seed)
    clock, out = 5.0, []
    for _ in range(steps):
        clock += rng.uniform(0.5, 1.5) * stride
        times = clock - np.abs(rng.normal(0, stride, n)) * (rng.rand(n) < 0.5)
        out.append((rng.rand(n).astype(np.float32), rng.rand(n).astype(np.float32), times))
    return out


@pytest.mark.parametrize("mode", [dict(window_s=10.0, num_windows=4, allowed_lateness_s=15.0),
                                  dict(window_s=12.0, num_windows=6, allowed_lateness_s=8.0, slide_s=4.0)])
def test_windowed_lifecycle_stamps_equal_jax(both_enabled, mode):
    import jax.numpy as jnp

    port = pt.Windowed(pt.MeanSquaredError(**CPU), **mode)
    ref = mt.Windowed(mt.MeanSquaredError(), **mode)
    quiet = pt.Windowed(pt.MeanSquaredError(**CPU), **mode)  # no label: no stamps
    port.lifecycle_label = ref.lifecycle_label = "w"
    for p, t, times in _window_stream(3):
        port.update(torch.from_numpy(p), torch.from_numpy(t), event_time=times)
        ref.update(jnp.asarray(p), jnp.asarray(t), event_time=times)
        quiet.update(torch.from_numpy(p), torch.from_numpy(t), event_time=times)
    got, want = pobs.LEDGER.ledgers("w"), jobs.LEDGER.ledgers("w")
    assert got and sorted(got) == sorted(want)
    assert all(set(e) == {"first_event", "last_event"} for e in got.values())
    assert all(e["first_event"] <= e["last_event"] for e in got.values())
    assert set(pobs.LEDGER.ledgers()) == {("w", w) for w in got}


# ------------------------------------------------------------- self-meter
def _latencies():
    rng = np.random.default_rng(2024)
    lat = rng.lognormal(mean=0.5, sigma=1.5, size=10_000)
    return np.concatenate([lat, [0.0, 1e-4, 5e-4, 2e7, 3e8, 1e-3, 1e7]])


def test_latency_meter_bit_equal_to_jax():
    lat = _latencies()
    meter, jmeter = pobs.LatencyMeter(), jobs.LatencyMeter()
    for x in lat:
        meter.observe(float(x))
        jmeter.observe(float(x))
    assert [meter.bucket(float(x)) for x in lat[:500]] == [jmeter.bucket(float(x)) for x in lat[:500]]
    np.testing.assert_array_equal(meter.counts, jmeter.counts)
    assert meter.total_ms == jmeter.total_ms and meter.nbytes == jmeter.nbytes
    for q in (0.0, 0.01, 0.25, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0):
        assert meter.quantile(q) == jmeter.quantile(q), q
        assert meter.error_bound(q) == jmeter.error_bound(q) or (np.isnan(meter.error_bound(q))
                                                                 and np.isnan(jmeter.error_bound(q)))
    assert meter.summary() == jmeter.summary()
    # merge: four shards fold to the whole
    shards = [pobs.LatencyMeter() for _ in range(4)]
    jshards = [jobs.LatencyMeter() for _ in range(4)]
    for i, x in enumerate(lat):
        shards[i % 4].observe(float(x))
        jshards[i % 4].observe(float(x))
    fold, jfold = pobs.merge_meters(shards), jobs.merge_meters(jshards)
    np.testing.assert_array_equal(fold.counts, jfold.counts)
    np.testing.assert_array_equal(fold.counts, meter.counts)
    assert fold.summary() == jfold.summary()
    assert pobs.merge_meters([]) is None
    empty = pobs.LatencyMeter()
    assert np.isnan(empty.quantile(0.5)) and np.isnan(empty.error_bound(0.5))


def test_latency_meter_errors_equal_jax():
    for module in (pselfmeter, jselfmeter):
        with pytest.raises(ValueError, match="alpha"):
            module.LatencyMeter(alpha=1.5)
        with pytest.raises(ValueError, match="min_value"):
            module.LatencyMeter(min_value=5.0, max_value=1.0)
        with pytest.raises(ValueError, match="NaN"):
            module.LatencyMeter().observe(float("nan"))
        with pytest.raises(ValueError, match="different grids"):
            module.LatencyMeter().merge_(module.LatencyMeter(alpha=0.02))


# ------------------------------------------------------- trajectory gate
def _write_rounds(tmp_path):
    rounds = {
        1: {"parsed": {"grouped_sync8_ms": 6.0, "collective_calls": 12, "sync_bytes": 4096,
                       "service_ingest_steps_per_s": 90.0, "publish_lag_ms": 1.0}},
        2: {"parsed": {"grouped_sync8_ms": 4.0, "collective_calls": 10, "sync_bytes": 4096,
                       "service_ingest_steps_per_s": 120.0, "keyed_sync_ms": 0.5}},
        3: {"parsed": {"grouped_sync8_ms": 5.0, "collective_calls": 10, "sync_retries": 0}},
        4: {"no_parsed": True},
    }
    for n, doc in rounds.items():
        (tmp_path / f"BENCH_r{n:02d}.json").write_text(json.dumps(doc))
    (tmp_path / "BENCH_r05.json").write_text("{not json")
    (tmp_path / "BENCH_final.json").write_text(json.dumps({"parsed": {"grouped_sync8_ms": 1.0}}))


@pytest.mark.parametrize("current", [
    {"grouped_sync8_ms": 4.5, "collective_calls": 10, "sync_bytes": 4096, "service_ingest_steps_per_s": 110.0},
    {"grouped_sync8_ms": 30.0, "collective_calls": 11, "sync_bytes": 2048, "service_ingest_steps_per_s": 20.0,
     "sync_retries": 2, "degraded_computes": 0, "keyed_sync_ms": 1.9},
    {"grouped_sync8_ms": 9.0, "keyed_sync_ms": 3.0, "wm_stragglers": True},
])
def test_check_trajectory_verdicts_equal_jax(tmp_path, current):
    _write_rounds(tmp_path)
    rounds, jrounds = pobs.load_rounds(str(tmp_path)), jobs.load_rounds(str(tmp_path))
    assert rounds == jrounds and [r["n"] for r in rounds] == [1, 2, 3]
    assert pobs.check_trajectory(current, rounds) == jobs.check_trajectory(current, jrounds)
    tol = {"ms_ratio": 1.1, "ms_slack_ms": 0.1}
    assert pobs.check_trajectory(current, rounds, tol) == jobs.check_trajectory(current, jrounds, tol)
    for name in ("MS_KEYS", "COUNT_KEYS", "RATE_KEYS", "FAULT_KEYS", "TOLERANCES"):
        assert getattr(pregress, name) == getattr(jregress, name), name


def test_trajectory_verdicts_name_the_regressions(tmp_path):
    _write_rounds(tmp_path)
    out = pobs.check_trajectory({"grouped_sync8_ms": 30.0, "collective_calls": 11, "sync_retries": 1},
                                pobs.load_rounds(str(tmp_path)))
    assert not out["ok"]
    assert out["checks"]["grouped_sync8_ms"]["status"] == "regression"
    assert out["checks"]["collective_calls"]["status"] == "regression"
    assert out["checks"]["sync_retries"]["status"] == "regression"
    assert out["checks"]["gather_hier_ms"]["status"] == "no-baseline"


# ----------------------------------------------------------------- timers
def test_time_fn_and_profile_metric_keys_equal_jax():
    import jax.numpy as jnp

    times = pt.profile_metric(pt.Accuracy(**CPU), torch.tensor([1, 0, 1]), torch.tensor([1, 1, 1]), iters=3)
    jtimes = mt.profile_metric(mt.Accuracy(), jnp.array([1, 0, 1]), jnp.array([1, 1, 1]), iters=3)
    assert sorted(times) == sorted(jtimes) == ["compute_ms", "update_ms"]
    assert all(v > 0.0 for v in times.values())
    assert pt.time_fn(lambda x: x + 1, torch.zeros(4), iters=3, warmup=1) > 0.0
    assert pt.time_fn(lambda: None, iters=2, warmup=0) >= 0.0
