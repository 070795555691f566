"""The deferred sync plane of the port: handles, the lag-k ring, ``LagController`` and the host plane.

Against the JAX package (``tests/parallel/test_deferred.py`` lists the
behaviours), on the CPU with fake worlds (``dist_sync_fn``) and no
``torch.distributed`` group in this process (``test_torch_sync_guarded.py``
runs the real collectives in subprocesses):

* ``deferred_host_gather`` resolves to the synchronous result, is idempotent
  and caches its error, carries the watermark, runs in submission order on
  the single worker, and reduces a copy: a ``Keyed`` state written in place
  after dispatch does not change the handle's result, nor that of a ready
  handle from ``sync_state(deferred=True)`` without a group;
* ``sync_lag = k`` for k = 1, 2, 3: every step's value equals the JAX
  package's lagged value (and the port's synchronous value k steps back), the
  epoch ``compute()`` drains the ring and equals the synchronous one; the
  ring holds its watermarks in entry order, a shrunk lag resolves the oldest,
  ``reset`` / ``clone`` / pickle / deepcopy never carry handles, validation
  errors are the JAX package's messages, the depth gauge is its layout;
* ``LagController`` fed the same ``wait_ms`` sequences follows the JAX
  package's lag trajectory step for step; ``sync_lag="auto"`` with a
  controller that judges every wait free stays synchronous (bit-exact), and
  one that judges every wait slow deepens the ring;
* chaos through the deferred plane: a transient drop retries to the exact
  result, a stall ten times its deadline is consumed, a persistent drop
  degrades without failing the step, a raise-policy exhaustion surfaces from
  ``result()`` and again from the cache;
* the host plane's ``shutdown`` runs the queued tasks, joins the worker and
  is usable again.

No test asserts on wall time. Tolerances: values from equal counts by the
same arithmetic are equal.
"""
import copy
import pickle
import threading
from collections import deque

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt
import metrics_tpu_torch as pt
from metrics_tpu.observability import counters as jcounters
from metrics_tpu.parallel import deferred as jdeferred
from metrics_tpu.parallel import sync as jsync
from metrics_tpu_torch.observability import counters as pcounters
from metrics_tpu_torch.parallel import deferred as pdeferred
from metrics_tpu_torch.parallel import faults as pfaults
from metrics_tpu_torch.parallel import sync as psync
from metrics_tpu_torch.utils.exceptions import SyncTimeoutError
from tests.test_torch_faults import plane_hygiene  # noqa: F401  (autouse: every test leaves the process clean)

torch.set_num_threads(1)
CPU = {"device": "cpu"}


@psync.packable_gather
def WORLD(value):
    """One process: the identity gather, packable like the JAX package's default."""
    return [value]


def _batches(n, rows=32, seed=0):
    rng = np.random.RandomState(seed)
    return [(rng.rand(rows).astype(np.float32), (rng.rand(rows) > 0.5).astype(np.int32)) for _ in range(n)]


def _port(b):
    return torch.from_numpy(b[0]), torch.from_numpy(b[1]).long()


def _jax(b):
    return jnp.asarray(b[0]), jnp.asarray(b[1])


def _acc(lag=0, gather=WORLD):
    m = pt.Accuracy(dist_sync_on_step=True, dist_sync_fn=gather, **CPU)
    m.sync_lag = lag
    return m


def _jacc(lag=0):
    m = mt.Accuracy(dist_sync_on_step=True, dist_sync_fn=jsync.gather_all_arrays)
    m.sync_lag = lag
    return m


# ------------------------------------------------------------ host handles
def test_deferred_host_gather_matches_synchronous():
    m = pt.Accuracy(**CPU)
    m.update(*_port(_batches(1)[0]))
    state = m._current_state()
    handle = pdeferred.deferred_host_gather(state, m._reductions, gather_fn=WORLD)
    out = handle.result()
    assert {k: int(v) for k, v in out.items()} == {k: int(v) for k, v in state.items()}
    assert handle.done() and handle.result() is out  # cached, not gathered again


def test_host_handle_reduces_a_copy_of_an_in_place_keyed_state():
    k = pt.Keyed(pt.MeanSquaredError(**CPU), num_slots=4)
    k.update(torch.tensor([1.0, 2.0, 3.0]), torch.tensor([0.0, 0.0, 0.0]), slot=torch.tensor([0, 1, 1]))
    before = {n: v.clone() for n, v in k._current_state().items()}
    gate = threading.Event()
    handle = pdeferred.deferred_host_gather(k._current_state(), k._reductions,
                                            gather_fn=psync.packable_gather(lambda v: (gate.wait(10), [v])[1]))
    # written in place while the gather waits on the worker
    k.update(torch.tensor([5.0, 7.0]), torch.tensor([0.0, 0.0]), slot=torch.tensor([0, 3]))
    gate.set()
    out = handle.result()
    for name, value in before.items():
        assert torch.equal(out[name], value), name
        assert not torch.equal(getattr(k, name), value), name  # the live state did move on


def test_deferred_gathers_run_in_submission_order():
    order = []
    gate = threading.Event()

    def slow(value):
        gate.wait(10)
        order.append("a")
        return [value]

    def fast(value):
        order.append("b")
        return [value]

    m = pt.Accuracy(**CPU)
    m.update(*_port(_batches(1)[0]))
    h_slow = pdeferred.deferred_host_gather(m._current_state(), m._reductions, gather_fn=slow)
    h_fast = pdeferred.deferred_host_gather(m._current_state(), m._reductions, gather_fn=fast)
    assert not h_fast.done()
    gate.set()
    h_fast.result()
    assert h_slow.done() and order == ["a", "a", "b", "b"]  # two tensors each, one call per tensor


def test_handle_carries_watermark_and_counts_its_lifecycle():
    pcounters.enable()
    m = pt.Accuracy(**CPU)
    for b in _batches(3):
        m.update(*_port(b))
    handle = pdeferred.deferred_host_gather(m._current_state(), m._reductions, gather_fn=WORLD,
                                            watermark=m.epoch_watermark)
    handle.result()
    assert handle.watermark == 3
    assert pcounters.snapshot()["deferred"] == {"dispatched": 1, "fenced": 1, "completed": 1}
    with pytest.raises(ValueError, match="unknown SyncHandle kind"):
        pdeferred.SyncHandle("later", None)


def test_deferred_sync_state_without_a_group_is_ready():
    col = pt.MetricCollection({"acc": pt.Accuracy(**CPU)})
    state = {"acc": {"correct": torch.tensor(3), "total": torch.tensor(5)}}
    handle = col.sync_state(state, deferred=True)
    assert isinstance(handle, pt.SyncHandle) and handle.done()
    assert {k: int(v) for k, v in handle.result()["acc"].items()} == {"correct": 3, "total": 5}
    assert int(pt.Accuracy(**CPU).sync_state(state["acc"], deferred=True).result()["total"]) == 5


def test_ready_handle_holds_a_copy_of_an_in_place_keyed_state():
    k = pt.Keyed(pt.MeanSquaredError(**CPU), num_slots=4)
    k.update(torch.tensor([1.0, 2.0, 3.0]), torch.tensor([0.0, 0.0, 0.0]), slot=torch.tensor([0, 1, 1]))
    before = {n: v.clone() for n, v in k._current_state().items()}
    col = pt.MetricCollection({"keyed": k})
    handle = k.sync_state(k._current_state(), deferred=True)
    nested = col.sync_state({"keyed": k._current_state()}, deferred=True)
    # written in place after dispatch: neither ready handle may see it
    k.update(torch.tensor([5.0, 7.0]), torch.tensor([0.0, 0.0]), slot=torch.tensor([0, 3]))
    for out in (handle.result(), nested.result()["keyed"]):
        for name, value in before.items():
            assert torch.equal(out[name], value), name
            assert not torch.equal(getattr(k, name), value), name  # the live state did move on


def test_deferred_sync_plane_binds_its_arguments():
    m = pt.Accuracy(**CPU)
    plane = pdeferred.DeferredSyncPlane(m._reductions, finish=lambda out: {k: int(v) for k, v in out.items()})
    handle = plane.dispatch({"correct": torch.tensor(4), "total": torch.tensor(9)}, watermark=2)
    assert handle.done() and handle.watermark == 2 and handle.result() == {"correct": 4, "total": 9}


# ---------------------------------------------------------------- lag-k ring
@pytest.mark.parametrize("k", [1, 2, 3])
def test_sync_lag_k_reads_k_steps_back_equal_jax(k):
    batches = _batches(k + 5, seed=40 + k)
    sync_m, lag_m, jlag = _acc(), _acc(k), _jacc(k)
    sync_vals = [float(sync_m(*_port(b))) for b in batches]
    lag_vals = [float(lag_m(*_port(b))) for b in batches]
    jvals = [float(jlag(*_jax(b))) for b in batches]
    assert lag_vals == jvals
    for i, v in enumerate(lag_vals):
        assert v == (sync_vals[i - k] if i >= k else sync_vals[i]), (k, i)
    assert len(lag_m._handle_ring) == k
    marks = [h.watermark for h in lag_m._handle_ring]
    assert marks == sorted(marks) == [len(batches) - k + 1 + i for i in range(k)]
    assert float(lag_m.compute()) == float(sync_m.compute()) == float(jlag.compute())
    assert not lag_m._handle_ring


def test_sync_lag_ring_overflow_resolves_oldest_equal_jax():
    batches = _batches(6, seed=45)
    sync_vals = [float(v) for v in (_acc()(*_port(b)) for b in batches)]
    m, j = _acc(3), _jacc(3)
    for b in batches[:4]:
        m(*_port(b))
        j(*_jax(b))
    m.sync_lag = j.sync_lag = 1
    got = [float(m(*_port(batches[4]))), float(m(*_port(batches[5])))]
    assert got == [float(j(*_jax(batches[4]))), float(j(*_jax(batches[5])))] == [sync_vals[3], sync_vals[4]]
    assert len(m._handle_ring) == 1
    assert float(m.compute()) == float(j.compute())


def test_reset_clone_pickle_and_deepcopy_drop_handles():
    batches = _batches(5, seed=46)
    m = _acc(2)
    m.persistent(True)
    for b in batches:
        m(*_port(b))
    assert len(m._handle_ring) == 2
    twin, back, clone = copy.deepcopy(m), pickle.loads(pickle.dumps(m)), m.clone()
    for c in (twin, back, clone):
        assert isinstance(c._handle_ring, deque) and not c._handle_ring and c._lag_controller is None
    expected = float(m.compute())
    assert float(twin.compute()) == float(back.compute()) == float(clone.compute()) == expected
    fresh = _acc(2)
    fresh.load_state_dict(m.state_dict())
    assert not fresh._handle_ring and fresh.epoch_watermark == m.epoch_watermark == 5
    m(*_port(batches[0]))
    m.reset()
    assert not m._handle_ring and m.epoch_watermark == 0


def test_setstate_drops_a_smuggled_ring():
    m = _acc(2)
    state = m.__getstate__()
    assert "_handle_ring" not in state and "_lag_controller" not in state
    state["_handle_ring"] = deque([object(), object()])
    state["_lag_controller"] = object()
    fresh = pt.Accuracy.__new__(pt.Accuracy)
    fresh.__setstate__(state)
    assert isinstance(fresh._handle_ring, deque) and not fresh._handle_ring and fresh._lag_controller is None


@pytest.mark.parametrize("kw", [dict(sync_lag=9), dict(sync_lag=-1), dict(sync_lag=1.5), dict(sync_lag=True),
                                dict(sync_lag=1), dict(sync_lag="auto"), dict(sync_lag="fast", dist_sync_on_step=True)])
def test_sync_lag_validation_equals_jax(kw):
    def toy(pkg):
        class _Toy(pkg.Metric):
            def __init__(self, **k):
                super().__init__(**k)
                self.add_state("n", default=np.zeros((), np.float32), dist_reduce_fx="sum")

            def update(self, x):
                self.n = self.n + x.sum()

            def compute(self):
                return self.n

        return _Toy

    with pytest.raises(ValueError) as ep:
        toy(pt)(**kw, **CPU)
    with pytest.raises(ValueError) as ej:
        toy(mt)(**kw)
    assert str(ep.value) == str(ej.value)
    assert pdeferred.MAX_SYNC_LAG == jdeferred.MAX_SYNC_LAG
    for ok in (1, pdeferred.MAX_SYNC_LAG, "auto"):
        toy(pt)(sync_lag=ok, dist_sync_on_step=True, **CPU)


def test_sync_lag_attribute_validates_at_first_use():
    bad = _acc()
    bad.sync_lag = pdeferred.MAX_SYNC_LAG + 1
    with pytest.raises(ValueError, match="sync_lag"):
        bad(*_port(_batches(1)[0]))


def test_lag_members_leave_the_shared_step_sync():
    a, b = _acc(), _acc(1)
    b.threshold = a.threshold
    col = pt.MetricCollection({"a": a, "b": b})
    shared = col._eager_shared_groups()
    assert shared == {"a": "a", "b": "a"} and not any("b" in pack for pack in col._step_sync_packs(shared))
    vals = [col(*_port(bt)) for bt in _batches(3, seed=13)]
    for i in range(1, 3):
        assert float(vals[i]["b"]) == float(vals[i - 1]["a"])
    col.compute()
    assert not b._handle_ring


def test_ring_depth_gauge_layout_equals_jax():
    batches = _batches(5, seed=47)
    m, j = _acc(2), _jacc(2)
    pcounters.enable()
    jcounters.reset()
    jcounters.enable()
    try:
        for b in batches:
            m(*_port(b))
            j(*_jax(b))
        got, want = pcounters.snapshot()["deferred_depth"], jcounters.snapshot()["deferred_depth"]
    finally:
        jcounters.disable()
    assert got == want == {"Accuracy": {"current": 2, "max": 2}}
    m.compute()
    j.compute()


# ------------------------------------------------------------ LagController
_WAITS = {
    "slow_then_free": [5.0] * 6 + [0.1] * 40,
    "spiky": [0.2, 3.0, 0.1, 0.1, 8.0, 0.5, 0.5, 0.9, 1.2, 0.0] * 5,
    "ramp": [0.05 * i for i in range(60)],
    "noisy": list(np.abs(np.random.RandomState(4).standard_cauchy(80))),
}


@pytest.mark.parametrize("name", sorted(_WAITS))
@pytest.mark.parametrize("kw", [dict(), dict(max_lag=3, free_ms=1.0, alpha=1.0, calm_steps=2),
                                dict(max_lag=5, free_ms=0.5, alpha=0.25, calm_steps=4)])
def test_lag_controller_trajectory_equals_jax(name, kw):
    port, ref = pdeferred.LagController(**kw), jdeferred.LagController(**kw)
    got = [port.observe(w) for w in _WAITS[name]]
    assert got == [ref.observe(w) for w in _WAITS[name]]
    assert port.wait_ms == ref.wait_ms and repr(port) == repr(ref)


@pytest.mark.parametrize("kw", [dict(max_lag=9), dict(max_lag=0), dict(free_ms=0.0), dict(alpha=0.0),
                                dict(calm_steps=0)])
def test_lag_controller_validation_equals_jax(kw):
    with pytest.raises(ValueError) as ep:
        pdeferred.LagController(**kw)
    with pytest.raises(ValueError) as ej:
        jdeferred.LagController(**kw)
    assert str(ep.value) == str(ej.value)


def test_sync_lag_auto_follows_its_controller():
    batches = _batches(6, seed=48)
    sync_m, free, slow = _acc(), _acc("auto"), _acc("auto")
    free._lag_controller = pdeferred.LagController(free_ms=1e9)  # every measured wait is free
    slow._lag_controller = pdeferred.LagController(free_ms=1e-12, alpha=1.0)  # every measured wait is slow
    for b in batches:
        assert float(free(*_port(b))) == float(sync_m(*_port(b)))
        slow(*_port(b))
    assert free._lag_controller.lag == 0 and not free._handle_ring
    assert slow._lag_controller.lag >= 1 and len(slow._handle_ring) >= 1
    assert float(slow.compute()) == float(sync_m.compute())
    auto = _acc("auto")
    auto(*_port(batches[0]))
    assert isinstance(auto._lag_controller, pdeferred.LagController)  # built at first use


# ------------------------------------------------------- chaos through the plane
def _state():
    m = pt.Accuracy(**CPU)
    m.update(*_port(_batches(1)[0]))
    return m._current_state(), m._reductions


def test_deferred_transient_drop_retries_bit_exact():
    state, red = _state()
    guard = psync.SyncGuard(max_retries=2, backoff_s=0.01)
    with pfaults.chaos(pfaults.FaultSpec(kind="drop", call=0, times=1)):
        out = pdeferred.deferred_host_gather(state, red, gather_fn=WORLD, guard=guard).result()
    assert {k: int(v) for k, v in out.items()} == {k: int(v) for k, v in state.items()}
    assert pcounters.snapshot()["faults"]["sync_retries"] == 1


def test_deferred_stall_is_consumed_by_the_deadline():
    state, red = _state()
    guard = psync.SyncGuard(deadline_s=0.05, max_retries=2, backoff_s=0.01)
    with pfaults.chaos(pfaults.FaultSpec(kind="stall", call=0, times=1, duration_s=0.5)) as inj:
        out = pdeferred.deferred_host_gather(state, red, gather_fn=WORLD, guard=guard).result()
    assert int(out["total"]) == int(state["total"]) and inj.injected["stall"] == 1
    assert pcounters.snapshot()["faults"]["sync_retries"] == 1


def test_deferred_persistent_drop_degrades_and_raise_surfaces_from_result():
    state, red = _state()
    two = psync.packable_gather(lambda v: [v, v])
    with pfaults.chaos(pfaults.FaultSpec(kind="drop", rate=1.0, times=100_000)):
        degraded = pdeferred.deferred_host_gather(
            state, red, gather_fn=two, guard=psync.SyncGuard(max_retries=1, backoff_s=0.01, policy="degrade"))
        raised = pdeferred.deferred_host_gather(state, red, gather_fn=two,
                                                guard=psync.SyncGuard(max_retries=1, backoff_s=0.01))
        out = degraded.result()
        with pytest.raises(SyncTimeoutError):
            raised.result()
    with pytest.raises(SyncTimeoutError):
        raised.result()  # the cached error, never half resolved
    assert {k: int(v) for k, v in out.items()} == {k: int(v) for k, v in state.items()}  # local, not doubled
    assert pcounters.snapshot()["faults"]["degraded_computes"] == 1


def test_guard_is_captured_at_dispatch():
    state, red = _state()
    gate = threading.Event()
    slow_world = psync.packable_gather(lambda v: (gate.wait(10), [v])[1])
    with pfaults.chaos(pfaults.FaultSpec(kind="drop", call=1, times=99)):
        first = pdeferred.deferred_host_gather(state, red, gather_fn=slow_world)  # the default guard: unwrapped
        handle = pdeferred.deferred_host_gather(state, red, gather_fn=WORLD)
        psync.set_sync_guard(psync.SyncGuard(max_retries=0, policy="degrade"))  # too late for both handles
        gate.set()
        try:
            first.result()
            with pytest.raises(pt.utils.exceptions.SyncTimeoutError):
                handle.result()  # captured the default guard: policy raise
        finally:
            psync.set_sync_guard(None)


def test_sync_lag_ring_under_chaos_advances_every_step():
    batches = _batches(8, seed=50)
    m, clean = _acc(3), _acc(3)
    guard = psync.SyncGuard(deadline_s=0.05, max_retries=2, backoff_s=0.01, policy="degrade", check_finite=True)
    old = psync.set_sync_guard(guard)
    try:
        with pfaults.ChaosInjector([pfaults.FaultSpec(kind="drop", call=1, times=1),
                                    pfaults.FaultSpec(kind="stall", call=3, times=1, duration_s=0.5),
                                    pfaults.FaultSpec(kind="corrupt", call=5, times=1)], seed=0):
            vals = [float(m(*_port(b))) for b in batches]
            m._drain_handle_ring()
    finally:
        psync.set_sync_guard(old)
    want = [float(clean(*_port(b))) for b in batches]
    assert vals == want  # every fault recovered: the same lagged values
    assert pcounters.snapshot()["faults"]["sync_retries"] >= 2


def test_sync_lag_under_persistent_drop_latches_degrade():
    batches = _batches(4, seed=21)
    m = _acc(1, gather=psync.packable_gather(lambda v: [v, v]))
    psync.set_sync_guard(psync.SyncGuard(max_retries=1, backoff_s=0.01, policy="degrade"))
    try:
        with pfaults.ChaosInjector([pfaults.FaultSpec(kind="drop", rate=1.0, times=100_000)], seed=0):
            vals = [float(m(*_port(b))) for b in batches]
            m._drain_handle_ring()
    finally:
        psync.set_sync_guard(None)
    local = [float(pt.Accuracy(**CPU)(*_port(b))) for b in batches]
    assert vals == [local[0]] + local[:3]  # each step reads the previous step's local value
    assert pcounters.snapshot()["faults"]["degraded_computes"] == 4


# ---------------------------------------------------------------- host plane
def test_host_plane_shutdown_runs_queued_tasks_then_recovers():
    done = []
    gate = threading.Event()
    pdeferred.host_plane_submit(lambda: (gate.wait(10), done.append(1)))
    pdeferred.host_plane_submit(lambda: done.append(2))
    assert pdeferred._HOST_PLANE.pending() >= 1
    threading.Timer(0.05, gate.set).start()
    pdeferred._HOST_PLANE.shutdown()
    assert done == [1, 2] and pdeferred._HOST_PLANE.pending() == 0
    pdeferred._HOST_PLANE.shutdown()  # idempotent
    pdeferred.drain_host_plane()  # no pool: a no-op
    assert pdeferred.host_plane_submit(lambda: 42).result(timeout=5.0) == 42


def test_host_plane_runs_tasks_from_many_threads_once_each_in_order():
    import sys

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    seen, futures, order = [], [], []
    lock = threading.Lock()
    try:
        def producer(w):
            for i in range(50):
                with lock:  # the submission order: the single worker must run the tasks in exactly that order
                    order.append((w, i))
                    futures.append(pdeferred.host_plane_submit(seen.append, (w, i)))

        threads = [threading.Thread(target=producer, args=(w,)) for w in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        assert not any(t.is_alive() for t in threads)
        pdeferred.drain_host_plane()
    finally:
        sys.setswitchinterval(old)
    assert all(f.done() for f in futures) and pdeferred._HOST_PLANE.pending() == 0
    assert len(seen) == 400 and seen == order
