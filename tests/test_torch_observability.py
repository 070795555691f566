"""The port's span tracer, counters schema and exports, against the JAX package.

* Disabled (the default) is a structural no-op: ``span()`` and ``annotate()``
  hand back one shared singleton, nothing is recorded, and no instrumented
  site of the port builds an attrs dict (every ``span`` call it makes while
  disabled passes ``None``).
* Enabled, spans nest with parent and depth per thread; the forward ->
  update -> compute -> sync nesting of the reference forward path is the JAX
  package's; ``traced`` records under the qualname.
* ``summarize`` gives the JAX package's table for the same records (columns
  ``state_bytes``, ``device_ms``, ``compile_ms``, ``e2e_ms``, ``flow_id``
  included); the Chrome events and flow events follow its schema;
  ``write_chrome_trace`` / ``write_jsonl`` round-trip through ``json``.
* Counters and spans recorded from 8 threads at once are exact (the twin of
  the JAX package's stress test).
* The counters snapshot has exactly the JAX package's keys, enabled or not.
* One ``MetricCollection([Accuracy, F1])`` loop of 3 seeded steps and an epoch
  ``compute()`` records the same span names, counts, parents and depths in
  both packages (the JAX package run in its unfused eager form); the names
  that differ by design are listed in ``_DIFFERENT_BY_DESIGN``, and none
  shows in this loop.

Every test leaves both packages' observability off and empty
(``obs_hygiene``, shared by the port's observability test files) and the
sync planes clean (``plane_hygiene``). Tolerances: counts and names are equal;
summaries of the same records are equal.
"""
import collections
import json
import sys
import threading
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt
import metrics_tpu.observability as jobs
import metrics_tpu_torch as pt
import metrics_tpu_torch.observability as pobs
from metrics_tpu.core import metric as jmetric
from metrics_tpu.observability import export as jexport
from metrics_tpu_torch.core import collections as pcollections
from metrics_tpu_torch.core import metric as pmetric
from metrics_tpu_torch.observability import counters as pcounters
from metrics_tpu_torch.observability import export as pexport
from metrics_tpu_torch.observability import profiler as pprofiler
from metrics_tpu_torch.observability import trace as ptrace
from metrics_tpu_torch.parallel import deferred as pdeferred
from metrics_tpu_torch.parallel import sharded_dispatch as psharded
from metrics_tpu_torch.utils import debug as pdebug
from tests.test_torch_faults import plane_hygiene  # noqa: F401  (autouse: every test leaves the process clean)

torch.set_num_threads(1)
CPU = {"device": "cpu"}

# span names of one package that the other never records, with the reason
_DIFFERENT_BY_DESIGN = {
    "collection.fused_step": "JAX only: the port has no fused collection step (its forward is the eager grouped path)",
    "collection.forward": "port only: the root of one collection step, so every span of a step shares its id",
    "collection.lockstep": "port only: the host-side lockstep check and record, which the JAX package's fused step"
                           " does not walk",
    "metric.forward_update": "port only: the batch delta inside the fused forward, where the JAX package's forward"
                             " records no update span",
}


def _without_by_design(records):
    """(name, parent, depth, metric) of each record whose name the JAX package also records, read as if the
    port's own spans were not there: the parent is the nearest enclosing span the JAX package records, the depth
    counts only such spans."""
    by_id = {r.span_id: r for r in records}
    out = []
    for r in records:
        if r.name in _DIFFERENT_BY_DESIGN:
            continue
        ancestors = []
        parent = by_id.get(r.parent_id)
        while parent is not None:
            if parent.name not in _DIFFERENT_BY_DESIGN:
                ancestors.append(parent.name)
            parent = by_id.get(parent.parent_id)
        out.append((r.name, ancestors[0] if ancestors else None, len(ancestors), (r.attrs or {}).get("metric")))
    return out


@pytest.fixture(autouse=True)
def obs_hygiene():
    """Before and after each test: the port's spans, counters, lifecycle
    ledger, self-meter, compile telemetry and device-time fencing off and
    empty, the sync-count check off; fails the test if it left a profiler
    session open."""
    pobs.disable()
    pobs.reset()
    yield
    problems = []
    if pprofiler.is_tracing():
        problems.append("a torch.profiler session was left open")
        session = pprofiler._SESSION.profile
        pprofiler._SESSION.profile = pprofiler._SESSION.log_dir = None
        ptrace.PROFILER_SCOPE = None
        session.stop()
    if pdebug.sync_count_check_enabled():
        problems.append("the sync-count check was left on")
        pdebug.enable_sync_count_check(False)
    pdeferred.drain_host_plane()
    pobs.disable()
    pobs.reset()
    assert not problems, problems


def _probs(rng, n, c):
    p = rng.random((n, c))
    return (p / p.sum(1, keepdims=True)).astype(np.float32)


# ------------------------------------------------------------ disabled path
def test_disabled_span_and_annotation_are_shared_singletons():
    assert pobs.span("a") is pobs.span("b", {"k": 1}) is ptrace._NULL_SPAN
    assert pobs.annotate("a") is pobs.annotate("b") is pprofiler._NULL
    with pobs.span("a") as sp:
        assert sp is ptrace._NULL_SPAN


def test_disabled_records_nothing():
    with pobs.span("not-recorded"):
        pass

    @pobs.traced("also-not-recorded")
    def fn():
        return 1

    assert fn() == 1
    m = pt.Accuracy(**CPU)
    m(torch.tensor([1, 0]), torch.tensor([1, 1]))
    m.compute()
    col = pt.MetricCollection([pt.F1(num_classes=3, average="macro", **CPU),
                               pt.Precision(num_classes=3, average="macro", **CPU)])
    col(torch.tensor([0, 1, 2]), torch.tensor([0, 2, 2]))
    col.compute()
    assert pobs.records() == []
    snap = pobs.counters_snapshot()
    assert snap["collective_calls"] == 0 and snap["state_bytes"] == {} and snap["group_cache"] == {"hits": 0,
                                                                                                   "misses": 0}


def test_no_site_builds_an_attrs_dict_while_disabled(monkeypatch):
    """Every instrumented module's ``span`` is replaced by a recorder: while
    tracing is off, each call it sees passes ``attrs=None`` (most sites do not
    call it at all). The same calls with tracing on reach the recorder from
    every site of a collection step (``collection.forward``,
    ``collection.lockstep`` in forward, update and compute,
    ``metric.forward_update``), so the loop covers them."""
    seen = []

    def recorder(name, attrs=None):
        seen.append((name, attrs))
        return ptrace._NULL_SPAN

    for module in (pmetric, pcollections, pdeferred, psharded):
        monkeypatch.setattr(module, "_span", recorder)

    def gather(x):
        return [x, x]

    rng = np.random.default_rng(0)
    col = pt.MetricCollection([pt.Accuracy(**CPU), pt.F1(num_classes=4, average="macro", **CPU),
                               pt.Precision(num_classes=4, average="macro", **CPU)])
    for m in col.values():
        m.dist_sync_fn, m.dist_sync_on_step = gather, True
    lagged = pt.Accuracy(dist_sync_on_step=True, dist_sync_fn=gather, **CPU)
    lagged.sync_lag = 1  # library metrics take the attribute

    def loop():
        for _ in range(3):
            p, t = torch.from_numpy(_probs(rng, 16, 4)), torch.from_numpy(rng.integers(0, 4, 16))
            col(p, t)
            col.update(p, t)
            lagged(p, t)
        col.compute()
        lagged.compute()
        col.deferred_epoch_sync = True
        col.compute()
        col.deferred_epoch_sync = False

    loop()
    assert all(attrs is None for _name, attrs in seen), seen
    assert pobs.records() == []
    pobs.enable()
    loop()
    pobs.disable()
    traced = collections.Counter(name for name, attrs in seen if attrs is not None)
    assert {"collection.forward", "collection.lockstep", "metric.forward_update"} <= set(traced), traced


# ------------------------------------------------------------- enabled path
def test_spans_nest_with_parent_and_depth():
    pobs.enable()
    with pobs.span("outer"):
        with pobs.span("inner", {"k": "v"}):
            pass
    outer, inner = pobs.records()
    assert (outer.name, inner.name) == ("outer", "inner")
    assert inner.parent == "outer" and inner.depth == 1 and inner.attrs == {"k": "v"}
    assert outer.parent is None and outer.depth == 0
    assert inner.start_ns >= outer.start_ns and inner.end_ns <= outer.end_ns


class _Unfusable(pt.Metric):
    """A non-associative callable reduction: the reference forward, whose
    wrapped ``update`` runs inside ``forward``."""

    def __init__(self):
        super().__init__(device="cpu")
        self.add_state("total", default=torch.zeros(()), dist_reduce_fx=lambda s: s[-1])

    def update(self, x):
        self.total = self.total + torch.sum(x)

    def compute(self):
        return self.total


class _JaxUnfusable(mt.Metric):
    def __init__(self):
        super().__init__()
        self.add_state("total", default=jnp.zeros(()), dist_reduce_fx=lambda s: s[-1])

    def update(self, x):
        self.total = self.total + jnp.sum(x)

    def compute(self):
        return self.total


def test_forward_update_sync_span_nesting_equals_jax():
    def shape(records):
        return sorted((r.name, r.parent, r.depth) for r in records)

    def port_shape(records):
        return sorted(row[:3] for row in _without_by_design(records))

    def gather(x):
        return [x, x]

    m, jm = _Unfusable(), _JaxUnfusable()
    m.dist_sync_fn = jm.dist_sync_fn = gather
    m.dist_sync_on_step = jm.dist_sync_on_step = True
    pobs.enable()
    jobs.reset()  # the JAX tracer is process-wide: an earlier test's spans must not count here
    jobs.enable()
    try:
        m(torch.arange(3.0))
        jm(jnp.arange(3.0))
        got, want = pobs.records(), jobs.records()
    finally:
        jobs.disable()
        jobs.reset()
    by_name = {r.name: r for r in got}
    assert by_name["metric.forward"].depth == 0
    assert by_name["metric.update"].parent == "metric.forward"
    assert by_name["metric.compute"].parent == "metric.forward"
    assert by_name["metric.sync_state"].parent == "metric.compute"
    assert by_name["metric.forward"].attrs == {"metric": "_Unfusable"}
    assert port_shape(got) == shape(want)
    # the reference forward runs the wrapped update: no port-only span on a single metric
    assert not [r.name for r in got if r.name in _DIFFERENT_BY_DESIGN]


def test_traced_decorator_records_under_qualname():
    pobs.enable()

    @pobs.traced()
    def my_phase():
        return 7

    assert my_phase() == 7
    (rec,) = pobs.records()
    assert rec.name.endswith("my_phase") and "test_traced_decorator_records_under_qualname" in rec.name


# ----------------------------------------------------------------- exports
def _records():
    """The same hand-made span records for both packages' exporters."""
    base = 1_000_000_000
    rows = [
        ("metric.update", 0, 400_000, None, 0, {"metric": "A", "state_bytes": 64, "device_ms": 0.25}),
        ("metric.update", 500_000, 1_100_000, None, 0, {"metric": "A", "state_bytes": 96, "device_ms": 0.5,
                                                        "compiled": "yes", "compile_ms": 3.0}),
        ("metric.compute", 1_200_000, 1_300_000, "metric.forward", 1, None),
        ("service.publish_dispatch", 1_350_000, 1_390_000, None, 0, {"flow": 7}),
        ("service.publish", 1_400_000, 1_900_000, None, 0, {"flow": 7, "e2e_ms": 2.5}),
        ("fleet.merge", 2_000_000, 2_100_000, None, 0, {"flow": [7, 9]}),
        ("shard.publish", 2_200_000, 2_300_000, None, 0, {"flow": 9}),
        ("singleton", 2_400_000, 2_500_000, None, 0, {"flow": 11}),
    ]
    tid = threading.main_thread().ident
    return ([ptrace.SpanRecord(n, base + s, base + e, tid, d, par, a) for n, s, e, par, d, a in rows],
            [jobs.SpanRecord(n, base + s, base + e, tid, d, par, a) for n, s, e, par, d, a in rows])


def test_summarize_equals_jax_on_the_same_records():
    recs, jrecs = _records()
    got, want = pexport.summarize(recs), jexport.summarize(jrecs)
    assert got == want
    for row in got.values():
        for column in ("state_bytes", "device_ms", "compile_ms", "e2e_ms", "flow_id"):
            assert column in row
    assert got["metric.update"]["state_bytes"] == 96 and got["metric.update"]["device_ms"] == 0.75
    assert got["fleet.merge"]["flow_id"] == 9


def test_chrome_events_and_flows_equal_jax_schema():
    recs, jrecs = _records()
    jobs.TRACE.epoch_anchor = ptrace.TRACE.epoch_anchor  # the same wall-clock mapping in both
    got, want = pexport.to_trace_events(recs), jexport.to_trace_events(jrecs)
    assert got == want
    for event in got:
        assert isinstance(event["name"], str) and event["ph"] in ("X", "M", "s", "t", "f")
        if event["ph"] == "X":
            assert isinstance(event["ts"], float) and event["dur"] >= 0
    flows = collections.defaultdict(list)
    for e in got:
        if e.get("cat") == "metrics_tpu.flow":
            flows[e["id"]].append(e["ph"])
    assert flows == {7: ["s", "t", "f"], 9: ["s", "f"]}


def test_write_chrome_trace_and_jsonl_round_trip(tmp_path):
    pobs.enable()
    with pobs.span("phase.a", {"metric": "M"}):
        with pobs.span("phase.b"):
            pass
    pcounters.record_collective("psum", torch.zeros(4, dtype=torch.float32))
    path = tmp_path / "trace.json"
    pobs.write_chrome_trace(str(path))
    doc = json.loads(path.read_text())
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert sorted(e["name"] for e in spans) == ["phase.a", "phase.b"]
    assert doc["otherData"]["collective_calls"] == 1 and doc["otherData"]["sync_bytes"] == 16
    pobs.write_jsonl(str(tmp_path / "t.jsonl"))
    lines = [json.loads(line) for line in (tmp_path / "t.jsonl").read_text().splitlines()]
    kinds = [line["type"] for line in lines]
    assert kinds == ["span", "span", "summary", "summary", "counters"]
    assert lines[0]["name"] == "phase.a" and lines[1]["parent"] == "phase.a" and lines[1]["depth"] == 1
    assert lines[-1]["collective_calls"] == 1


# ------------------------------------------------------- thread stress twin
_STRESS_THREADS = 8
_STRESS_ITERS = 200


def test_counters_and_spans_are_exact_under_8_thread_stress():
    pobs.enable()
    barrier = threading.Barrier(_STRESS_THREADS)
    errors = []

    def worker(tid):
        try:
            barrier.wait(timeout=10)
            for i in range(_STRESS_ITERS):
                pcounters.record_collective("psum", torch.zeros(4, dtype=torch.float32))
                pcounters.record_fault("sync_retries")
                pcounters.record_deferred("dispatched")
                pcounters.record_deferred("completed")
                pcounters.record_state_bytes(f"Stress{tid}", i)
                pcounters.record_states_synced(1)
                with ptrace.span("stress.phase", {"tid": tid}):
                    pass
        except BaseException as err:  # noqa: BLE001  (surfaced on the main thread)
            errors.append(err)

    threads = [threading.Thread(target=worker, args=(t,), daemon=True) for t in range(_STRESS_THREADS)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads often: a lost update would show
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
            assert not t.is_alive(), "stress worker wedged"
    finally:
        sys.setswitchinterval(interval)
    assert not errors, errors
    total = _STRESS_THREADS * _STRESS_ITERS
    snap = pobs.counters_snapshot()
    assert snap["calls_by_kind"]["psum"] == total and snap["sync_bytes"] == total * 16
    assert snap["faults"]["sync_retries"] == total
    assert snap["deferred"]["dispatched"] == total and snap["deferred"]["completed"] == total
    assert snap["states_synced"] == total
    assert all(snap["state_bytes"][f"Stress{t}"] == _STRESS_ITERS - 1 for t in range(_STRESS_THREADS))
    recs = [r for r in pobs.records() if r.name == "stress.phase"]
    assert len(recs) == total and {r.attrs["tid"] for r in recs} == set(range(_STRESS_THREADS))


# ---------------------------------------------------------- snapshot schema
@pytest.mark.parametrize("enabled", [False, True])
def test_snapshot_keys_equal_jax(enabled):
    if enabled:
        pobs.enable()
    got = pobs.counters_snapshot()
    want = jobs.counters_snapshot()
    assert set(got) == set(want)
    for block in ("service_health", "fleet_shards", "slab_slots", "retention", "lifecycle", "watermark_lag",
                  "publish_staleness", "selfmeter", "deferred_depth", "watermark_agreement", "heavy_hitters",
                  "state_bytes"):
        assert got[block] == {}, block
    for cache in ("group", "step", "launch", "fused_step", "ingest_program"):
        assert got[f"{cache}_cache"] == {"hits": 0, "misses": 0}
    assert pobs.compile_snapshot().keys() == jobs.compile_snapshot().keys()


# submodules of the JAX package's observability package that the port names otherwise, with the reason
_MODULES_DIFFERENT_BY_DESIGN = {"jaxprof": ("profiler", "it drives torch.profiler; the same three names")}


def test_observability_names_equal_jax():
    assert set(pobs.__all__) == set(jobs.__all__)
    for jax_name, (port_name, _reason) in _MODULES_DIFFERENT_BY_DESIGN.items():
        jmod, pmod = getattr(jobs, jax_name), getattr(pobs, port_name)
        assert set(jmod.__all__) <= set(pmod.__all__), jax_name
        assert not hasattr(pobs, jax_name)
    for name in jobs.__all__:
        assert hasattr(pobs, name), name
    for name in jobs.counters.__all__:
        assert hasattr(pcounters, name), name
    assert pt.enable_sync_count_check is pdebug.enable_sync_count_check


def test_state_bytes_gauge_and_span_column():
    pobs.enable()
    m = pt.AUROC(capacity=64, **CPU)
    m.update(torch.rand(10), torch.randint(0, 2, (10,)))
    sk = pt.AUROC(approx="sketch", **CPU)
    sk.update(torch.rand(10), torch.randint(0, 2, (10,)))
    want_buffer = 64 * 4 + 64 * 8 + 2 * 8  # float32 preds, int64 target, two int64 counts
    snap = pobs.counters_snapshot()["state_bytes"]
    assert snap["AUROC"] == pcounters.state_nbytes(sk._current_state())  # the latest write wins
    assert pcounters.state_nbytes(m._current_state()) == want_buffer
    updates = [r for r in pobs.records() if r.name == "metric.update"]
    assert [r.attrs["state_bytes"] for r in updates] == [want_buffer, pcounters.state_nbytes(sk._current_state())]
    # a gauge: the column is the largest footprint (here the sketch's 2 x 2,048 int64 bins)
    assert pobs.summarize()["metric.update"]["state_bytes"] == max(want_buffer, 2 * 2048 * 8)


# ------------------------------------------------- span parity on one loop
def _loop_records(package, obs):
    rng = np.random.default_rng(11)
    if package is pt:
        col = pt.MetricCollection([pt.Accuracy(**CPU), pt.F1(num_classes=4, average="macro", **CPU)])
    else:
        col = mt.MetricCollection([mt.Accuracy(), mt.F1(num_classes=4, average="macro")])
    obs.reset()  # read from an empty buffer: an earlier test may have left spans behind
    obs.enable()
    try:
        values = []
        for _ in range(3):
            p, t = _probs(rng, 32, 4), rng.integers(0, 4, 32)
            if package is pt:
                out = col(torch.from_numpy(p), torch.from_numpy(t))
            else:
                out = col(jnp.asarray(p), jnp.asarray(t.astype(np.int32)))
            values.append({k: float(v) for k, v in out.items()})
        values.append({k: float(v) for k, v in col.compute().items()})
        return obs.records(), values
    finally:
        obs.disable()
        obs.reset()


def test_span_names_counts_and_nesting_equal_jax_on_a_collection_loop():
    old = jmetric.set_default_jit(False)  # the JAX package's eager form: the port has no fused step
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got, values = _loop_records(pt, pobs)
            want, jvalues = _loop_records(mt, jobs)
    finally:
        jmetric.set_default_jit(old)
    names = collections.Counter(r.name for r in got if r.name not in _DIFFERENT_BY_DESIGN)
    jnames = collections.Counter(r.name for r in want if r.name not in _DIFFERENT_BY_DESIGN)
    assert names == jnames
    assert names == {"metric.forward": 6, "metric.compute": 8, "collection.compute": 1}
    # the port's own: a root a step, a lockstep check and record a step and the epoch sync's check, an update
    # span a member's fused forward
    assert collections.Counter(r.name for r in got if r.name in _DIFFERENT_BY_DESIGN) == {
        "collection.forward": 3, "collection.lockstep": 7, "metric.forward_update": 6}
    assert sorted(_without_by_design(got)) == sorted(
        (r.name, r.parent, r.depth, (r.attrs or {}).get("metric")) for r in want)
    np.testing.assert_allclose([list(v.values()) for v in values], [list(v.values()) for v in jvalues], rtol=1e-6)


@pytest.mark.parametrize("reader", ["forward_nesting", "collection_loop"])
def test_jax_side_reads_start_empty_after_a_span_left_behind(reader):
    """The JAX tracer's buffer is process-wide: a span an earlier test left in it
    (observability switched off without a reset) must not reach the comparisons
    that read it."""
    jobs.enable()
    with jobs.span("leftover"):
        pass
    jobs.disable()
    assert [r.name for r in jobs.records()] == ["leftover"]
    try:
        if reader == "forward_nesting":
            test_forward_update_sync_span_nesting_equals_jax()
        else:
            test_span_names_counts_and_nesting_equal_jax_on_a_collection_loop()
    finally:
        jobs.disable()
        jobs.reset()
