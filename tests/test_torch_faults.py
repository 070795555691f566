"""The guard plane, the chaos injector and the integrity guard of the port, against the JAX package.

* The chaos injector's verdicts: for the same schedule and seed, the rate
  verdicts (gather drops, ``verdict()``, the ingest kinds with shards and
  ranks) are the JAX package's sequence, call for call; validation errors
  are its messages.
* The guard's outcomes on ``host_gather`` with fake worlds (a stall ten
  times its deadline recovered, drop exhaustion raising ``SyncTimeoutError``
  or degrading to the local state, a corrupted payload retried, corruption
  exhaustion raising ``StateCorruptionError``, a preemption at once, the
  unwrapped fast path, the empty-state skip): the same values, raised types,
  injector counts and fault counters as the JAX package's ``host_gather`` on
  the same schedule. The states are one float32 and one int32 bucket in both
  packages, so ``FaultSpec(call=i)`` addresses the same call in both.
* The integrity scan (``nonfinite_count``, ``saturated_count``,
  ``state_integrity_counts``) on seeded states equals the JAX package's
  counts; the ``check_finite`` policies (warn / raise / quarantine) act as its
  do, and the quarantine restores a copy: a ``Keyed`` / ``Windowed`` state
  written in place after the snapshot leaves the restored state as it was.
* ``guarded_update``: the checkpoint / preempt / restore / replay loop ends
  bit-equal to the unbroken run and to the JAX package's; spans that
  straddle the watermark raise ``ValueError`` in both.

Every test leaves the process as it found it (the ``plane_hygiene`` fixture,
shared with ``test_torch_deferred.py`` and ``test_torch_sync_guarded.py``):
both packages' default guards and no fault hook, both host planes drained,
none of the JAX package's guard threads alive, the JAX package's observability switch as it
was (its counters reset when a test recorded into them) and no
``torch.distributed`` group in this process. No test asserts on wall time.

Tolerances: counts, fault counters and verdicts are equal; float values of
equal states by the same arithmetic are equal.
"""
import pickle
import threading
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import metrics_tpu as mt
import metrics_tpu.observability as jobs
import metrics_tpu_torch as pt
from metrics_tpu.observability import counters as jcounters
from metrics_tpu.parallel import deferred as jdeferred
from metrics_tpu.parallel import faults as jfaults
from metrics_tpu.parallel import sync as jsync
from metrics_tpu.utils import exceptions as jexc
from metrics_tpu_torch.observability import counters as pcounters
from metrics_tpu_torch.parallel import deferred as pdeferred
from metrics_tpu_torch.parallel import faults as pfaults
from metrics_tpu_torch.parallel import sync as psync
from metrics_tpu_torch.utils import exceptions as pexc

torch.set_num_threads(1)
CPU = {"device": "cpu"}
_GUARD_THREADS = ("mtpu-sync-guard", "mtpu-sync-degraded")  # the JAX package's; the port's guard starts none


@pytest.fixture(autouse=True)
def plane_hygiene():
    """Saves, restores and, after each test, asserts the process-wide state
    of both packages' sync planes."""
    jax_enabled = jobs.is_enabled()
    jax_before = jcounters.snapshot()
    port_enabled = pcounters.is_enabled()
    pcounters.reset()
    yield
    problems = []
    if psync.current_sync_guard() != psync.SyncGuard():
        problems.append(f"port guard left set: {psync.current_sync_guard()}")
        psync.set_sync_guard(None)
    if psync._FAULT_HOOK is not None:
        problems.append("port fault hook left installed")
        psync._FAULT_HOOK.uninstall()
    pdeferred.drain_host_plane()
    if pdeferred._HOST_PLANE.pending():
        problems.append(f"port host plane holds {pdeferred._HOST_PLANE.pending()} tasks")
    jdeferred.drain_host_plane()
    if jsync.current_sync_guard() != jsync.SyncGuard():
        problems.append(f"JAX guard left set: {jsync.current_sync_guard()}")
        jsync.set_sync_guard(None)
    if jsync._FAULT_HOOK is not None:
        problems.append("JAX fault hook left installed")
        jsync._FAULT_HOOK = None
    for thread in threading.enumerate():
        if thread.name in _GUARD_THREADS:
            thread.join(10.0)  # an abandoned attempt's stall or fire-and-forget call ending
            if thread.is_alive():
                problems.append(f"guard thread {thread.name} still alive")
    if jobs.is_enabled() != jax_enabled:
        problems.append("JAX observability switch changed")
        (jobs.enable if jax_enabled else jobs.disable)()
    if jcounters.snapshot() != jax_before:
        jcounters.reset()
    pcounters.reset()
    (pcounters.enable if port_enabled else pcounters.disable)()
    if dist.is_available() and dist.is_initialized():
        problems.append("a torch.distributed group is initialized in the pytest process")
        dist.destroy_process_group()
    assert not problems, problems


def _faults():
    return pcounters.snapshot()["faults"], jcounters.snapshot()["faults"]


def _reset_counters():
    pcounters.reset()
    jcounters.reset()


# ------------------------------------------------------------ chaos verdicts
@pytest.mark.parametrize("seed", [0, 7, 123])
@pytest.mark.parametrize("rate", [0.1, 0.5, 0.9])
def test_gather_drop_verdicts_equal_jax(seed, rate):
    def verdicts(faults_mod):
        inj = faults_mod.ChaosInjector([faults_mod.FaultSpec(kind="drop", rate=rate, times=1)], seed=seed)
        out = []
        for idx in range(64):
            for attempt in (0, 1):  # a retry sees the cached verdict
                try:
                    inj.before_call("host_gather", idx, attempt)
                    out.append(False)
                except Exception as err:  # noqa: BLE001
                    out.append(type(err).__name__)
        return out, dict(inj.injected)

    assert verdicts(pfaults) == verdicts(jfaults)


@pytest.mark.parametrize("seed", [3, 11])
def test_rate_verdicts_stable_across_threads_and_equal_jax(seed):
    spec, jspec = pfaults.FaultSpec(kind="drop", rate=0.5), jfaults.FaultSpec(kind="drop", rate=0.5)
    inj, jinj = pfaults.ChaosInjector([spec], seed=seed), jfaults.ChaosInjector([jspec], seed=seed)
    want = [jinj.verdict(jspec, "host_gather", i) for i in range(64)]
    results = {}

    def probe(worker):
        results[worker] = [inj.verdict(spec, "host_gather", i) for i in range(64)]

    threads = [threading.Thread(target=probe, args=(w,)) for w in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert all(r == want for r in results.values()) and len(results) == 4
    assert any(want) and not all(want)


@pytest.mark.parametrize("site, dims", [("service.ingest", "rank"), ("fleet.shard", "shard"),
                                        ("fleet.shard", "both")])
def test_ingest_rate_matrices_equal_jax(site, dims):
    def matrix(faults_mod):
        schedule = [faults_mod.FaultSpec(kind="ingest_stall", rate=0.5, site=site),
                    faults_mod.FaultSpec(kind="late_burst", rate=0.3, skew_s=5.0, site=site)]
        inj = faults_mod.ChaosInjector(schedule, seed=5)
        out = {}
        for a in range(4):
            for idx in range(12):
                kw = {"rank": a} if dims == "rank" else {"shard": a} if dims == "shard" else {"shard": a, "rank": 3 - a}
                out[(a, idx)] = ([s.kind for s in inj.ingest_faults(site, idx, **kw)],
                                 inj.ingest_addressed(site, idx, **kw))
        return out, dict(inj.injected)

    assert matrix(pfaults) == matrix(jfaults)


def test_ingest_call_addressing_equals_jax():
    def run(faults_mod):
        f = faults_mod.FaultSpec
        schedule = [f(kind="ingest_stall", call=2, times=3, site="service.ingest"),
                    f(kind="drop", call=2, times=3, site="service.ingest"),
                    f(kind="preempt", call=3, site="fleet.shard", shard=2),
                    f(kind="clock_skew", call=2, skew_s=30.0, site="service.ingest", rank=1),
                    f(kind="late_burst", call=4, skew_s=5.0, site="fleet.shard", shard=0, rank=2)]
        inj = faults_mod.ChaosInjector(schedule, seed=0)
        fired = [[s.kind for s in inj.ingest_faults("service.ingest", i, rank=r)] for i in range(7) for r in (None, 1)]
        fired += [[s.kind for s in inj.ingest_faults("fleet.shard", i, shard=s, rank=r)]
                  for i in range(6) for s in (0, 2) for r in (1, 2)]
        return fired, dict(inj.injected), inj.ingest_faults("host_gather", 2)

    assert run(pfaults) == run(jfaults)


@pytest.mark.parametrize("spec", [
    dict(kind="meteor", call=0), dict(kind="drop"), dict(kind="clock_skew", skew_s=5.0),
    dict(kind="preempt", call=0, shard=-1), dict(kind="preempt", call=0, shard=1.5),
    dict(kind="preempt", call=0, rank=-1), dict(kind="preempt", call=0, rank=0.5),
])
def test_injector_validation_equals_jax(spec):
    with pytest.raises(ValueError) as ep:
        pfaults.ChaosInjector([pfaults.FaultSpec(**spec)])
    with pytest.raises(ValueError) as ej:
        jfaults.ChaosInjector([jfaults.FaultSpec(**spec)])
    assert str(ep.value) == str(ej.value)


def test_injector_install_lifecycle():
    with pfaults.chaos(pfaults.FaultSpec(kind="drop", call=0)) as inj:
        assert pfaults.current_injector() is inj and psync._FAULT_HOOK is inj
        with pytest.raises(RuntimeError, match="already installed"):
            pfaults.ChaosInjector([pfaults.FaultSpec(kind="drop", call=0)]).install()
    assert pfaults.current_injector() is None
    assert pfaults.FAULT_KINDS == jfaults.FAULT_KINDS and pfaults.SERVICE_FAULT_KINDS == jfaults.SERVICE_FAULT_KINDS
    assert pfaults.FaultSpec._fields == jfaults.FaultSpec._fields
    assert pfaults.FaultSpec._field_defaults == jfaults.FaultSpec._field_defaults


# ------------------------------------------------------- the guard's outcomes
def _states():
    port = {"x": torch.arange(4.0), "n": torch.tensor(3, dtype=torch.int32)}
    ref = {"x": jnp.arange(4.0), "n": jnp.asarray(3, dtype=jnp.int32)}
    return port, ref, {"x": "sum", "n": "sum"}


def _worlds(ranks):
    port = psync.packable_gather(lambda v: [v] * ranks)
    ref = jsync.packable_gather(lambda v: [v] * ranks)
    return port, ref


_SCENARIOS = {
    # name: (fault specs, guard, ranks, expected outcome: "ok" / exception name)
    # the JAX package runs each deadline-bound attempt on a thread: a deadline well above thread start-up under load
    "stall_recovers": ([dict(kind="stall", call=0, times=1, duration_s=2.5)],
                       dict(deadline_s=0.25, max_retries=2, backoff_s=0.01), 2, "ok"),
    "drop_transient": ([dict(kind="drop", call=1, times=2)], dict(max_retries=2, backoff_s=0.01), 2, "ok"),
    "drop_raise": ([dict(kind="drop", call=0, times=99)], dict(max_retries=1, backoff_s=0.01), 2, "SyncTimeoutError"),
    "drop_degrade": ([dict(kind="drop", call=0, times=99)],
                     dict(max_retries=1, backoff_s=0.01, policy="degrade"), 2, "ok"),
    "corrupt_retried": ([dict(kind="corrupt", call=0, times=1)],
                        dict(max_retries=2, backoff_s=0.01, check_finite=True), 2, "ok"),
    "corrupt_exhausted": ([dict(kind="corrupt", call=1, times=99)],
                          dict(max_retries=1, backoff_s=0.01, check_finite=True), 2, "StateCorruptionError"),
    "corrupt_unchecked": ([dict(kind="corrupt", call=0, times=1)], dict(max_retries=1), 2, "ok"),
    "preempt": ([dict(kind="preempt", call=0)], dict(deadline_s=1.0, max_retries=5, backoff_s=0.01,
                                                     policy="degrade"), 2, "PreemptionError"),
    "rate_drops": ([dict(kind="drop", rate=0.5, times=1)], dict(max_retries=1, backoff_s=0.0), 3, "ok"),
}


def _scenario(name, pkg):
    specs, guard, ranks, _ = _SCENARIOS[name]
    port_state, ref_state, red = _states()
    port_world, ref_world = _worlds(ranks)
    faults_mod, sync_mod = (pfaults, psync) if pkg == "port" else (jfaults, jsync)
    state, world = (port_state, port_world) if pkg == "port" else (ref_state, ref_world)
    with faults_mod.ChaosInjector([faults_mod.FaultSpec(**s) for s in specs], seed=4) as inj:
        try:
            if pkg == "port":
                out = psync.host_gather(state, red, world, guard=psync.SyncGuard(**guard))
            else:
                out = jsync.host_gather(state, red, gather_fn=world, guard=jsync.SyncGuard(**guard))
            outcome = "ok"
            values = {k: np.where(np.isnan(a := np.asarray(v, np.float64)), -1.0, a).tolist() for k, v in out.items()}
        except (pexc.MetricsTorchError, jexc.MetricsTPUError) as err:
            outcome, values = type(err).__name__, None
    return outcome, values, dict(inj.injected), dict(inj.calls)


@pytest.mark.parametrize("name", sorted(_SCENARIOS))
def test_guard_outcomes_equal_jax(name):
    _reset_counters()
    port = _scenario(name, "port")
    ref = _scenario(name, "jax")
    assert port == ref
    assert port[0] == _SCENARIOS[name][3]
    got, want = _faults()
    assert got == want, name
    if name in ("stall_recovers", "drop_transient", "corrupt_retried"):
        assert port[1] == {"x": [0.0, 2.0, 4.0, 6.0], "n": 6}  # bit-equal to the unfaulted 2-rank sum
        assert got["sync_retries"] >= 1 and got["degraded_computes"] == 0
    if name == "drop_degrade":
        assert port[1] == {"x": [0.0, 1.0, 2.0, 3.0], "n": 3} and got["degraded_computes"] == 1
    if name == "corrupt_unchecked":
        assert port[1]["x"] == [-1.0] * 4  # without check_finite the poison (NaN, here -1) flows through


def test_default_guard_keeps_the_unwrapped_fast_path():
    calls = []
    world = psync.packable_gather(lambda v: (calls.append(v), [v])[1])
    state, _ref, red = _states()
    out = psync.host_gather(state, red, world)
    assert len(calls) == 2  # one packed call per dtype bucket (float32, int32), as in the JAX package
    assert not psync._GuardPlane().active
    assert {k: np.asarray(v).tolist() for k, v in out.items()} == {"x": [0.0, 1.0, 2.0, 3.0], "n": 3}
    assert all(v == 0 for v in pcounters.snapshot()["faults"].values())


def test_empty_and_all_none_states_skip_the_collective():
    calls = []
    world = psync.packable_gather(lambda v: (calls.append(v), [v])[1])
    assert psync.host_gather({}, {}, world) == {}
    assert psync.host_gather({"a": None}, {"a": "sum"}, world) == {"a": None}
    out = psync.host_gather({"a": None, "x": torch.arange(3.0)}, {"a": "sum", "x": "sum"}, world)
    assert out["a"] is None and out["x"].tolist() == [0.0, 1.0, 2.0]
    assert len(calls) == 1 and pcounters.snapshot()["gather_skips"] == 2


def test_set_sync_guard_validates_and_restores():
    with pytest.raises(ValueError, match="policy") as ep:
        psync.set_sync_guard(psync.SyncGuard(policy="ignore"))
    with pytest.raises(ValueError, match="policy") as ej:
        jsync.set_sync_guard(jsync.SyncGuard(policy="ignore"))
    assert str(ep.value) == str(ej.value)
    old = psync.set_sync_guard(psync.SyncGuard(deadline_s=1.0))
    try:
        assert old == psync.SyncGuard() and psync.current_sync_guard().deadline_s == 1.0
    finally:
        psync.set_sync_guard(None)
    assert psync.SyncGuard._fields == jsync.SyncGuard._fields
    assert psync.SyncGuard._field_defaults == jsync.SyncGuard._field_defaults


# ---------------------------------------------------------- integrity counts
def _integrity_inputs(seed):
    rng = np.random.RandomState(seed)
    f = rng.randn(64).astype(np.float32)
    f[rng.rand(64) < 0.2] = np.nan
    f[rng.rand(64) < 0.1] = np.inf
    out = {"f": f}
    for dtype in (np.int32, np.int16, np.int8, np.uint8):
        info = np.iinfo(dtype)
        x = rng.randint(info.min // 2, info.max // 2, size=48).astype(dtype)
        margin = max(info.max // 2048, 1)
        picks = rng.rand(48)
        x[picks < 0.1] = info.max - rng.randint(0, margin + 1)
        x[picks > 0.9] = info.min + rng.randint(0, margin + 1)
        x[(picks > 0.45) & (picks < 0.5)] = info.max - margin - 1  # just outside the margin
        out[np.dtype(dtype).name] = x
    return out


@pytest.mark.parametrize("seed", range(4))
def test_integrity_counts_equal_jax(seed):
    arrays = _integrity_inputs(seed)
    port = {k: torch.from_numpy(v) for k, v in arrays.items()}
    ref = {k: jnp.asarray(v) for k, v in arrays.items()}
    got = [int(c) for c in pt.state_integrity_counts(port)]
    want = [int(c) for c in mt.state_integrity_counts(ref)]
    assert got == want and got[0] > 0 and got[1] > 0
    assert int(pt.nonfinite_count(port)) == int(mt.nonfinite_count(ref))
    assert int(pt.saturated_count(port)) == int(mt.saturated_count(ref))
    for name, value in port.items():  # each leaf alone, too
        assert [int(c) for c in pt.state_integrity_counts({name: value})] == \
            [int(c) for c in mt.state_integrity_counts({name: ref[name]})], name


def test_integrity_counts_of_int64_sketches_buffers_and_lists():
    big = torch.tensor([torch.iinfo(torch.int64).max - 3, 5, torch.iinfo(torch.int64).min + 1])
    state = {"n": big, "sk": pt.parallel.sketch.HistogramSketch(torch.tensor([[1, 2], [3, 4]])),
             "buf": pt.parallel.PaddedBuffer(torch.tensor([[1.0, float("nan")], [0.0, 0.0]]), torch.tensor(1)),
             "l": [torch.tensor([float("inf"), 1.0]), torch.tensor([2.0])], "b": torch.tensor([True, False])}
    assert [int(c) for c in pt.state_integrity_counts(state)] == [2, 2]
    poisoned = pfaults.corrupt_pytree(state, fraction=0.5)
    assert [int(c) for c in pt.state_integrity_counts(poisoned)] == [4, 2]
    assert torch.isnan(poisoned["buf"].data).sum() == 2 and not torch.isnan(state["buf"].data[0, 0])


def test_corrupt_pytree_equals_jax():
    rng = np.random.RandomState(2)
    arrays = {"a": rng.rand(5, 3).astype(np.float32), "n": np.arange(4, dtype=np.int32)}
    for fraction in (0.2, 0.5, 1.0):
        got = pfaults.corrupt_pytree({k: torch.from_numpy(v) for k, v in arrays.items()}, fraction=fraction)
        want = jfaults.corrupt_pytree({k: jnp.asarray(v) for k, v in arrays.items()}, fraction=fraction)
        for k in arrays:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


# -------------------------------------------------------- check_finite policies
_BAD = ([np.nan, 1.0], [0.0, 1.0])
_GOOD = ([1.0, 2.0], [1.0, 1.0])


def _mse(pkg, policy):
    m = pt.MeanSquaredError(**CPU) if pkg is pt else mt.MeanSquaredError()
    m.check_finite = policy
    return m


def _batch(pkg, pair):
    conv = (lambda x: torch.tensor(x, dtype=torch.float32)) if pkg is pt else (lambda x: jnp.asarray(x, jnp.float32))
    return tuple(conv(x) for x in pair)


@pytest.mark.parametrize("call", ["update", "forward"])
def test_check_finite_policies_equal_jax(call):
    _reset_counters()
    for pkg in (pt, mt):
        m = _mse(pkg, "raise")
        step = m.update if call == "update" else m
        with pytest.raises(pexc.StateCorruptionError if pkg is pt else jexc.StateCorruptionError,
                           match="integrity scan"):
            step(*_batch(pkg, _BAD))
        m = _mse(pkg, "warn")
        with pytest.warns(UserWarning, match="integrity scan"):
            (m.update if call == "update" else m)(*_batch(pkg, _BAD))
    values = {}
    for pkg in (pt, mt):
        m = _mse(pkg, "quarantine")
        step = m.update if call == "update" else m
        step(*_batch(pkg, _GOOD))
        before = float(m.compute())
        with pytest.warns(UserWarning, match="quarantined"):
            step(*_batch(pkg, _BAD))
        values[pkg.__name__] = (before, float(m.compute()), m.epoch_watermark)
    assert values["metrics_tpu_torch"] == values["metrics_tpu"]
    assert values["metrics_tpu"][0] == values["metrics_tpu"][1]  # the poisoned delta is discarded
    got, want = _faults()
    assert got == want and got["quarantined_updates"] == 1


def _toy(pkg):
    class _Toy(pkg.Metric):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.add_state("n", default=np.zeros((), np.float32), dist_reduce_fx="sum")

        def update(self, x):
            self.n = self.n + x.sum()

        def compute(self):
            return self.n

    return _Toy


def test_check_finite_validation_equals_jax():
    with pytest.raises(ValueError) as ep:
        _toy(pt)(check_finite="loud", **CPU)
    with pytest.raises(ValueError) as ej:
        _toy(mt)(check_finite="loud")
    assert str(ep.value) == str(ej.value)
    assert pt.core.metric.CHECK_FINITE_POLICIES == mt.core.metric.CHECK_FINITE_POLICIES


def test_saturated_count_state_warns_near_wraparound():
    m = _mse(pt, "warn")
    m.update(torch.tensor([1.0]), torch.tensor([1.0]))
    m.total = torch.tensor(torch.iinfo(torch.int64).max - 3)
    with pytest.warns(UserWarning, match="near-saturated"):
        m.update(torch.tensor([1.0]), torch.tensor([1.0]))


def _keyed(pkg, policy, slots=3):
    inner = pt.MeanSquaredError(**CPU) if pkg is pt else mt.MeanSquaredError()
    k = pkg.Keyed(inner, num_slots=slots)
    k.check_finite = policy
    return k


def _arr(pkg, x, dtype=np.float32):
    x = np.asarray(x, dtype=dtype)
    return torch.from_numpy(x) if pkg is pt else jnp.asarray(x)


@pytest.mark.parametrize("call", ["update", "forward"])
def test_keyed_quarantine_drops_only_the_poisoned_step_equal_jax(call):
    out = {}
    for pkg in (pt, mt):
        k = _keyed(pkg, "quarantine")
        step = k.update if call == "update" else k
        step(_arr(pkg, [1.0, 2.0, 5.0]), _arr(pkg, [1.0, 1.0, 1.0]), slot=_arr(pkg, [0, 1, 1], np.int32))
        before = np.asarray(k.compute()).copy()
        with pytest.warns(UserWarning, match="quarantined"):
            step(_arr(pkg, [np.nan, 3.0, 3.0]), _arr(pkg, [1.0, 1.0, 1.0]), slot=_arr(pkg, [2, 0, 1], np.int32))
        out[pkg.__name__] = (before, np.asarray(k.compute()))
    for got, want in zip(out["metrics_tpu_torch"], out["metrics_tpu"]):
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(out["metrics_tpu"][0], out["metrics_tpu"][1])


def test_quarantine_restores_a_copy_of_an_in_place_keyed_state():
    """``Keyed.update`` writes its slabs in place (``index_add_``): the
    quarantine's snapshot is a copy, so the restored state equals the state
    before the poisoned update, tensor for tensor, not the written one."""
    k = _keyed(pt, "quarantine", slots=4)
    k.update(torch.tensor([1.0, 2.0, 5.0]), torch.tensor([1.0, 1.0, 1.0]), slot=torch.tensor([0, 1, 1]))
    live = k._current_state()
    before = {n: v.clone() for n, v in live.items()}
    with pytest.warns(UserWarning, match="quarantined"):
        k.update(torch.tensor([3.0, np.nan]), torch.tensor([1.0, 1.0]), slot=torch.tensor([0, 3]))
    for name, value in before.items():
        assert torch.equal(getattr(k, name), value), name
    # the in-place write did land in the old tensors: the restore is not an alias of them
    assert not torch.equal(live["keyed_rows"], before["keyed_rows"])
    assert getattr(k, "keyed_rows") is not live["keyed_rows"]


def test_quarantine_restores_a_copy_of_an_in_place_windowed_state():
    w = pt.Windowed(pt.MeanSquaredError(**CPU), window_s=10.0, num_windows=4, allowed_lateness_s=20.0)
    w.check_finite = "quarantine"
    clean = pt.Windowed(pt.MeanSquaredError(**CPU), window_s=10.0, num_windows=4, allowed_lateness_s=20.0)
    feed = [(torch.tensor([1.0, 2.0, 3.0]), torch.tensor([0.0, 0.0, 1.0]), np.array([1.0, 5.0, 12.0])),
            (torch.tensor([4.0, 0.5]), torch.tensor([1.0, 1.0]), np.array([13.0, 14.0]))]
    for p, t, et in feed:
        w.update(p, t, event_time=et)
        clean.update(p, t, event_time=et)
    live = w._current_state()
    with pytest.warns(UserWarning, match="quarantined"):
        w(torch.tensor([np.nan, 1.0]), torch.tensor([1.0, 1.0]), event_time=np.array([15.0, 16.0]))
    for name, value in clean._current_state().items():
        assert torch.equal(getattr(w, name), value), name
    assert all(getattr(w, n) is not v for n, v in live.items())
    assert w.epoch_watermark == 3 and pcounters.snapshot()["faults"]["quarantined_updates"] == 1


def test_keyed_min_slab_identity_fills_pass_the_scan():
    class _Low(pt.Metric):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.add_state("low", default=torch.tensor(float("inf")), dist_reduce_fx="min")

        def update(self, values):
            self.low = torch.minimum(self.low, values.min())

        def compute(self):
            return self.low

    keyed = pt.Keyed(_Low(**CPU), num_slots=4)
    keyed.check_finite = "warn"
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        keyed.update(torch.tensor([1.0, 2.0]), slot=torch.tensor([0, 1]))
    assert [int(c) for c in pt.state_integrity_counts(keyed._current_state())] == [2, 0]  # the +inf fills
    with pytest.warns(UserWarning, match="integrity scan"):
        keyed.update(torch.tensor([np.nan]), slot=torch.tensor([2]))


# ------------------------------------------------------------ guarded_update
def _acc_batches(n, rows=16, seed=3):
    rng = np.random.RandomState(seed)
    return [(rng.rand(rows).astype(np.float32), rng.randint(0, 2, rows).astype(np.int32)) for _ in range(n)]


def test_preempt_checkpoint_restore_replay_equals_jax():
    batches = _acc_batches(5)
    world = psync.packable_gather(lambda v: [v])

    def build():
        m = pt.Accuracy(dist_sync_on_step=True, dist_sync_fn=world, **CPU)
        m.persistent(True)
        return m

    def t(b):
        return torch.from_numpy(b[0]), torch.from_numpy(b[1]).long()

    reference = build()
    assert all(reference.guarded_update(i, *t(b)) for i, b in enumerate(batches))
    victim = build()
    victim.guarded_update(0, *t(batches[0]))
    victim.guarded_update(1, *t(batches[1]))
    checkpoint = pickle.loads(pickle.dumps(victim.state_dict()))
    with pfaults.chaos(pfaults.FaultSpec(kind="preempt", call=0)):
        with pytest.raises(pexc.PreemptionError):
            victim(*t(batches[2]))
    restored = build()
    restored.load_state_dict(checkpoint)
    assert restored.epoch_watermark == 2
    applied = [restored.guarded_update(i, *t(b)) for i, b in enumerate(batches)]
    assert applied == [False, False, True, True, True]
    ref = mt.Accuracy()
    for i, b in enumerate(batches):
        ref.guarded_update(i, jnp.asarray(b[0]), jnp.asarray(b[1]))
    assert float(restored.compute()) == float(reference.compute()) == float(ref.compute())
    assert restored.epoch_watermark == ref.epoch_watermark == 5


def test_guarded_update_spans_equal_jax():
    batches = _acc_batches(6, seed=8)
    logs = {}
    for pkg in (pt, mt):
        m = pkg.Accuracy(**CPU) if pkg is pt else pkg.Accuracy()
        conv = (lambda b: (torch.from_numpy(b[0]), torch.from_numpy(b[1]).long())) if pkg is pt else \
            (lambda b: (jnp.asarray(b[0]), jnp.asarray(b[1])))
        log = [m.guarded_update(0, *conv(batches[0])),
               m.guarded_update(1, *conv(batches[1]), span_end=3), m.epoch_watermark,
               m.guarded_update(2, *conv(batches[2]), span_end=3),  # a replayed span: no-op
               m.guarded_update(3, *conv(batches[3]))]
        for lo, hi in ((3, 5), (5, 4)):
            try:
                m.guarded_update(lo, *conv(batches[4]), span_end=hi)
                log.append("applied")
            except ValueError as err:
                log.append(str(err))
        log += [m.guarded_update(4, *conv(batches[5]), span_end=6), m.epoch_watermark, float(m.compute())]
        logs[pkg.__name__] = log
    assert logs["metrics_tpu_torch"] == logs["metrics_tpu"]
    assert "straddles the epoch watermark" in logs["metrics_tpu"][5]


def test_collection_guarded_update_and_watermark_equal_jax():
    batches = _acc_batches(4, seed=12)
    out = {}
    for pkg in (pt, mt):
        kw = CPU if pkg is pt else {}
        col = pkg.MetricCollection([pkg.Accuracy(**kw), pkg.Precision(**kw)])
        conv = (lambda b: (torch.from_numpy(b[0]), torch.from_numpy(b[1]).long())) if pkg is pt else \
            (lambda b: (jnp.asarray(b[0]), jnp.asarray(b[1])))
        applied = [col.guarded_update(i, *conv(b)) for i, b in enumerate(batches)]
        applied += [col.guarded_update(i, *conv(b)) for i, b in enumerate(batches)]
        out[pkg.__name__] = (applied, col.epoch_watermark, {k: float(v) for k, v in col.compute().items()})
    assert out["metrics_tpu_torch"] == out["metrics_tpu"]


def test_astype_and_state_pytree():
    m = pt.MeanSquaredError(**CPU)
    m.update(torch.tensor([1.0, 2.0]), torch.tensor([0.0, 0.0]))
    assert m.astype(torch.float64) is m
    assert m.sum_squared_error.dtype == torch.float64 and m.total.dtype == torch.int64
    m.reset()
    assert m.sum_squared_error.dtype == torch.float64  # the cast survives a reset
    assert set(m.state_pytree()) == {"sum_squared_error", "total"}
    j = mt.MeanSquaredError()
    j.update(jnp.asarray([1.0, 2.0]), jnp.asarray([0.0, 0.0]))
    assert set(j.state_pytree()) == set(m.state_pytree())
