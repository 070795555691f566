"""The port's ``MetricFleet`` and ``HeavyHitterFleet`` against the JAX package's.

* ``shard_for_key`` / ``shards_for_keys`` equal the JAX functions on a pinned
  corpus (str, bytes, int and mixed keys, 1-64 shards) and the pinned FNV-1a
  values of ``tests/serving/test_fleet.py``.
* A 4-shard fleet (and a 1- and 2-shard one) over a tenant-keyed stream with
  late events: every merged record and the merged view equal the JAX
  fleet's, and every window equals one service over the union of the stream.
* A shard killed mid-stream (seeded ``preempt`` at ``fleet.shard``) and
  recovered by ``recover_shard``: no window lost, none merged twice, records
  equal to the fleet that was not interrupted; the replay no-ops the overlap.
* ``HeavyHitterFleet`` over Zipf keys: the global top-k (keys, counts,
  exactness, shards, values), ``tail_mass`` and ``tail_overcount_bound``
  equal the JAX fleet's.
* ``health_report`` and the ``fleet_shards`` gauge.

Tolerances: window ids, rows, shard lists, flags and counts are equal; values
from equal counts (Accuracy) are equal.
"""
import numpy as np
import pytest

import metrics_tpu as mt
import metrics_tpu.serving as jserving
import metrics_tpu_torch as pt
import metrics_tpu_torch.observability as pobs
import metrics_tpu_torch.serving as pserving
from metrics_tpu.parallel import faults as jfaults
from metrics_tpu_torch.parallel import faults as pfaults
from tests.test_torch_faults import plane_hygiene  # noqa: F401  (autouse)
from tests.test_torch_observability import obs_hygiene  # noqa: F401  (autouse)
from tests.test_torch_serving_service import (  # noqa: F401  (serving_hygiene: autouse)
    CPU, W, assert_records_equal, one_process_gather, serving_hygiene, to_pkg,
)

NW, LATE = 4, 20.0

_KEYS = {
    "str": np.array([f"tenant-{i}" for i in range(257)] + ["", "雪", "a\x00b"]),
    "bytes": np.array([b"tenant-0", b"", b"a\x00b", b"\xff\xfe\x01"], dtype="S"),
    "int": np.array([0, 1, -1, 12345, -(2**62), 2**62], dtype=np.int64),
    "mixed": np.array(["a", b"a", 1, "1"], dtype=object),
}


def _factory(pkg):
    kw = {} if pkg is mt else CPU
    return lambda: pkg.Windowed(pkg.Accuracy(**kw), window_s=W, num_windows=NW, allowed_lateness_s=LATE,
                                dist_sync_fn=one_process_gather(pkg))


def _balanced_keys(per_shard, shards):
    keys, buckets, j = [], {s: 0 for s in range(shards)}, 0
    while any(v < per_shard for v in buckets.values()):
        key = f"tenant-{j}"
        j += 1
        s = pserving.shard_for_key(key, shards)
        if buckets[s] < per_shard:
            buckets[s] += 1
            keys.append(key)
    return keys


def _stream(n=24, size=12, seed=0, shards=4):
    """Tenant batches (the tenants balanced over the shards), a fifth of each
    batch's events late by up to 8 s: nothing is dropped."""
    rng = np.random.RandomState(seed)
    keys = _balanced_keys(max(n // shards, 1), shards)
    out = []
    for i in range(n):
        t = i * 2.5 + rng.uniform(0, 2.5, size)
        t = np.where(rng.rand(size) < 0.2, t - rng.uniform(0, 8.0, size), t)
        out.append((keys[i % len(keys)], t, rng.rand(size).astype(np.float32),
                    rng.randint(0, 2, size).astype(np.int32)))
    return out


def _fleet_run(pkg, stream, num_shards=4, chaos=None):
    faults = jfaults if pkg is mt else pfaults
    injector = faults.ChaosInjector([faults.FaultSpec(**c) for c in chaos], seed=0).install() if chaos else None
    recovered = 0
    try:
        fleet = pkg.MetricFleet(_factory(pkg), num_shards=num_shards, name="fleet")
        for key, t, p, y in stream:
            try:
                fleet.submit(key, to_pkg(pkg, p), to_pkg(pkg, y), event_time=t)
            except (pserving.ShardStoppedError, jserving.ShardStoppedError) as err:
                fleet.recover_shard(err.shard)
                recovered += 1
        try:
            fleet.flush()
        except Exception:  # noqa: BLE001 - a kill the submissions never saw surfaces at the barrier
            for i, svc in enumerate(fleet.shards):
                if svc.state != "running":
                    fleet.recover_shard(i)
                    recovered += 1
        merged = np.asarray(fleet.finalize())
        fleet.stop()
    finally:
        if injector is not None:
            injector.uninstall()
    return {"records": list(fleet.merged_records), "merged": merged, "recovered": recovered,
            "replayed": sum(s.replayed_steps for s in fleet.shards), "fleet": fleet}


def _union_service(stream):
    """One port service fed the whole stream in order: the single-process truth."""
    svc = pt.MetricService(_factory(pt)(), name="union")
    for i, (_key, t, p, y) in enumerate(stream):
        svc.submit(to_pkg(pt, p), to_pkg(pt, y), event_time=t, seq=i)
    merged = np.asarray(svc.finalize())
    svc.stop()
    return svc.publications, merged


# ------------------------------------------------------------------ routing
@pytest.mark.parametrize("kind", sorted(_KEYS))
def test_router_equals_jax_on_a_pinned_corpus(kind):
    keys = _KEYS[kind]
    for n in (1, 2, 7, 8, 64):
        got = pserving.shards_for_keys(keys, n)
        np.testing.assert_array_equal(got, jserving.shards_for_keys(keys, n))
        assert got.dtype == np.int64
        assert [pserving.shard_for_key(k, n) for k in keys] == [jserving.shard_for_key(k, n) for k in keys]
    assert pserving.stable_key_hash("tenant-0") == 0x1CE48A04A2FF1955
    assert pserving.stable_key_hash(b"tenant-0") == 0x3D82925F040C1B10
    assert pserving.stable_key_hash(12345) == 0xDBD8F4A96E701FD1
    with pytest.raises(ValueError, match="num_shards"):
        pserving.shard_for_key("t", 0)
    assert pserving.FLEET_SITE == jserving.FLEET_SITE


def test_constructor_validation_equals_jax():
    for pkg in (mt, pt):
        for bad, match in (
            (dict(metric_factory=_factory(pkg), num_shards=0), "num_shards"),
            (dict(metric_factory="nope", num_shards=2), "callable"),
            (dict(metric_factory=lambda: _factory(pkg)().metric, num_shards=2), "Windowed"),
            (dict(metric_factory=_factory(pkg), num_shards=2, replay_log=0), "replay_log"),
        ):
            with pytest.raises(ValueError, match=match):
                pkg.MetricFleet(**bad)


# --------------------------------------------------------------- merge tier
@pytest.mark.parametrize("num_shards", [1, 2, 4])
def test_merged_records_equal_jax_and_one_service_over_the_union(num_shards):
    stream = _stream(shards=num_shards)
    port, ref = _fleet_run(pt, stream, num_shards), _fleet_run(mt, stream, num_shards)
    assert_records_equal(port["records"], ref["records"], skip=())
    np.testing.assert_array_equal(port["merged"], ref["merged"])
    windows = [r["window"] for r in port["records"]]
    assert windows == sorted(set(windows)) and len(windows) >= 6
    union, union_merged = _union_service(stream)
    assert [r["window"] for r in union] == windows
    for rec, one in zip(port["records"], union):
        np.testing.assert_array_equal(rec["value"], one["value"])
    np.testing.assert_array_equal(port["merged"], union_merged)


def test_recover_shard_loses_no_window_and_merges_none_twice():
    stream = _stream(n=24)
    kill = pserving.shard_for_key(stream[2][0], 4)
    chaos = [dict(kind="preempt", call=4, times=1, site=pserving.FLEET_SITE, shard=kill)]
    port, ref = _fleet_run(pt, stream, chaos=chaos), _fleet_run(mt, stream, chaos=chaos)
    plain = _fleet_run(pt, stream)
    assert port["recovered"] == ref["recovered"] == 1 and port["replayed"] >= 1
    assert_records_equal(port["records"], plain["records"], skip=())
    np.testing.assert_array_equal(port["merged"], plain["merged"])
    assert_records_equal(port["records"], ref["records"], skip=())
    assert port["replayed"] == ref["replayed"]
    with pytest.raises(ValueError, match="shard must be in"):
        port["fleet"].recover_shard(4)


def test_health_report_and_shard_gauges():
    pobs.enable()
    stream = _stream(n=12)
    run = _fleet_run(pt, stream)
    report = run["fleet"].health_report()
    assert set(report) == {"fleet", "shards", "degraded_shards", "merged_through", "latency", "staleness_s"}
    assert report["merged_through"] == run["records"][-1]["window"] and report["degraded_shards"] == []
    assert set(report["shards"]) == {"0", "1", "2", "3"} and report["staleness_s"] >= 0.0
    assert {"ingest", "e2e"} <= set(report["latency"])
    shards = pobs.counters_snapshot()["fleet_shards"]["fleet"]
    assert set(shards) == {"0", "1", "2", "3"}
    assert sum(s["published"] for s in shards.values()) == sum(len(s.publications) for s in run["fleet"].shards)


# ------------------------------------------------------------ heavy hitters
def _zipf_rounds(n=8, per=8, shards=4, seed=5):
    """Zipf(1.1) key batches, each holding ``per`` keys of every shard (equal
    per-shard batch shapes keep the JAX package's compiled updates few)."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        buckets = {s: [] for s in range(shards)}
        while any(len(b) < per for b in buckets.values()):
            for k in rng.zipf(1.1, 64) % 10_000:
                s = pserving.shard_for_key(int(k), shards)
                if len(buckets[s]) < per:
                    buckets[s].append(int(k))
        keys = [k for s in range(shards) for k in buckets[s]]
        out.append((keys, rng.rand(len(keys)).astype(np.float32), rng.randint(0, 2, len(keys)).astype(np.int32)))
    return out


def test_heavy_hitter_fleet_topk_and_certificate_equal_jax():
    fleets = {pkg: pkg.HeavyHitterFleet(
        lambda pkg=pkg: pkg.HeavyHitters(pkg.Accuracy(**({} if pkg is mt else CPU)), num_hot_slots=8, tail=(4, 512)),
        num_shards=4) for pkg in (mt, pt)}
    for keys, preds, target in _zipf_rounds():
        for pkg, fleet in fleets.items():
            fleet.submit(keys, to_pkg(pkg, preds), to_pkg(pkg, target))
    got, want = fleets[pt].compute_heavy_hitters(k=6), fleets[mt].compute_heavy_hitters(k=6)
    assert [(r["key"], r["count"], r["exact"], r["shard"]) for r in got] == [
        (r["key"], r["count"], r["exact"], r["shard"]) for r in want]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g["value"]), np.asarray(w["value"]))
    assert fleets[pt].tail_mass() == fleets[mt].tail_mass() > 0
    assert fleets[pt].tail_overcount_bound() == pytest.approx(fleets[mt].tail_overcount_bound(), rel=1e-12)
    key = got[0]["key"]
    np.testing.assert_array_equal(np.asarray(fleets[pt].compute(key)), np.asarray(fleets[mt].compute(key)))
    with pytest.raises(ValueError, match="zero-arg callable"):
        pt.HeavyHitterFleet("nope", 2)
    with pytest.raises(ValueError, match="HeavyHitters"):
        pt.HeavyHitterFleet(lambda: pt.Accuracy(**CPU), 2)
