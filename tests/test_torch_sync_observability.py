"""The sync planes under observability, across three real processes (Gloo).

Three ranks over ``torch.distributed`` (Gloo, a FileStore under ``tmp_path``),
each fed its own seeded batches, with ``all_reduce`` / ``all_gather``
wrapped to record every collective (kind, dtype, size) in entry order:

* ``MetricCollection.deferred_epoch_sync``: a collection of two shared
  groups (F1 / Precision macro, F1 / Precision micro) and a singleton
  (Accuracy) computes the same epoch values with the deferred epoch plane as
  with the synchronous one, entering the same collectives in the same order,
  over the bucketed plane and over the host plane (``dist_sync_fn``); both
  equal one process fed every rank's batches. The deferred epoch records
  the ``MetricCollection.epoch`` depth gauge and ``collection.host_sync``
  spans stamped ``deferred="yes"``.
* The debug sync-count check: with ``enable_sync_count_check()`` on every
  rank, a rank that skipped a synced ``compute()`` (its peers' collectives
  still paired with a bare ``all_reduce_state`` of the same state) makes
  every rank raise the JAX package's message at the next synced
  ``compute()``; ranks that agree pass, at the cost of one ``all_gather``.
* ``deferred.*`` spans on their threads: with ``sync_lag=1`` over the host
  plane, ``deferred.dispatch`` and ``deferred.fence`` are on the caller's
  thread and ``deferred.complete`` on the host plane's single worker
  (``mtpu-torch-deferred-host``), with the ``plane`` / ``label`` /
  ``lag_controller`` attrs; over the bucketed plane, dispatch and fence.
* A chaos-degraded sync (``parallel/faults.py``'s ``ChaosInjector``, every
  gather dropped, ``policy="degrade"``): the ``collection.step_sync`` span of
  a collection's packed step and the ``metric.sync_state`` span of a metric
  stepped alone carry ``degraded="yes"``.

Every child is killed if it outlives its timeout; this process never joins a
group. Tolerances: counts and collective records are equal; values from
equal counts by the same arithmetic are equal.
"""
import json
import os
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import metrics_tpu_torch as pt
from tests.test_torch_faults import plane_hygiene  # noqa: F401  (autouse: every test leaves the process clean)
from tests.test_torch_observability import obs_hygiene  # noqa: F401  (autouse: observability off and empty)

torch.set_num_threads(1)

_REPO = Path(__file__).resolve().parents[1]
_WORLD = 3
_STEPS = 4
_ROWS = (24, 17, 30)
_CLASSES = 5

_WORKER = textwrap.dedent("""
    import contextlib, json, sys, threading, warnings
    import numpy as np, torch, torch.distributed as dist
    sys.path.insert(0, sys.argv[4])
    import metrics_tpu_torch as pt
    from metrics_tpu_torch import observability as obs
    from metrics_tpu_torch.parallel import deferred as pdeferred, faults, sync

    warnings.simplefilter("ignore")
    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=3)
    data = json.load(open(sys.argv[5]))
    batches = [(torch.tensor(p, dtype=torch.float32), torch.tensor(t)) for p, t in data[rank]]
    res = {}

    calls = []
    real_reduce, real_gather = dist.all_reduce, dist.all_gather
    def reduce(tensor, *a, **k):
        calls.append(["all_reduce", str(tensor.dtype), tensor.numel()])
        return real_reduce(tensor, *a, **k)
    def gather(outs, tensor, *a, **k):
        calls.append(["all_gather", str(tensor.dtype), tensor.numel()])
        return real_gather(outs, tensor, *a, **k)
    dist.all_reduce, dist.all_gather = reduce, gather

    def collection(host):
        kw = {"device": "cpu"}
        col = pt.MetricCollection({
            "f1_macro": pt.F1(num_classes=5, average="macro", **kw),
            "p_macro": pt.Precision(num_classes=5, average="macro", **kw),
            "f1_micro": pt.F1(num_classes=5, average="micro", **kw),
            "p_micro": pt.Precision(num_classes=5, average="micro", **kw),
            "acc": pt.Accuracy(**kw),
        })
        if host:
            for m in col.values():
                m.dist_sync_fn = sync._world_gather
        return col

    def epoch(host, deferred):
        col = collection(host)
        col.deferred_epoch_sync = deferred
        for b in batches:
            col.update(*b)
        obs.enable()
        del calls[:]
        try:
            values = {k: float(v) for k, v in col.compute().items()}
            pdeferred.drain_host_plane()
            spans = [[r.name, r.attrs] for r in obs.records() if r.name == "collection.host_sync"]
            depth = obs.counters_snapshot()["deferred_depth"]
        finally:
            obs.disable()
            obs.reset()
        return {"values": values, "calls": list(calls), "spans": spans, "depth": depth,
                "groups": [list(g) for g in col.compute_groups.values()]}

    for host in (False, True):
        for deferred in (False, True):
            res[f"epoch_{host}_{deferred}"] = epoch(host, deferred)

    # the debug sync-count check: every rank agrees, then rank 1 skips a synced compute
    m = pt.Accuracy(device="cpu")
    m.update(*batches[0])
    old = pt.enable_sync_count_check(True)
    try:
        del calls[:]
        res["agree_value"] = float(m.compute())
        res["agree_calls"] = list(calls)
        m.update(*batches[1])
        if rank == 1:
            # the same collectives as the skipped compute's sync, so every peer's still pair
            sync.all_reduce_state(m._current_state(), m._reductions)
        else:
            pt.enable_sync_count_check(False)
            m.compute()
            pt.enable_sync_count_check(True)
        m.update(*batches[2])
        try:
            m.compute()
            res["mismatch"] = "no error"
        except RuntimeError as err:
            res["mismatch"] = str(err)
    finally:
        pt.enable_sync_count_check(old)

    # deferred spans and their threads: sync_lag=1 over the host plane and over the bucketed plane
    def lagged(host):
        obs.enable()
        try:
            m = pt.Accuracy(device="cpu", dist_sync_on_step=True)
            if host:
                m.dist_sync_fn = sync._world_gather
            m.sync_lag = 1
            for b in batches:
                m(*b)
            m.compute()
            pdeferred.drain_host_plane()
            names = {t.ident: t.name for t in threading.enumerate()}
            main = threading.main_thread().ident
            return [[r.name, "main" if r.thread_id == main else names.get(r.thread_id, "gone"), r.attrs]
                    for r in obs.records() if r.name.startswith("deferred.")]
        finally:
            obs.disable()
            obs.reset()

    res["lag_host"] = lagged(True)
    res["lag_device"] = lagged(False)

    # a chaos-degraded sync stamps its span degraded=yes
    obs.enable()
    old = sync.set_sync_guard(sync.SyncGuard(max_retries=1, backoff_s=0.01, policy="degrade"))
    try:
        col = pt.MetricCollection([pt.Accuracy(device="cpu", dist_sync_on_step=True),
                                   pt.F1(num_classes=5, average="macro", device="cpu", dist_sync_on_step=True),
                                   pt.Precision(num_classes=5, average="macro", device="cpu", dist_sync_on_step=True)])
        alone = pt.Accuracy(device="cpu", dist_sync_on_step=True)
        with faults.ChaosInjector([faults.FaultSpec(kind="drop", rate=1.0, times=10**6)], seed=1):
            for b in batches[:2]:
                col(*b)
                alone(*b)
        res["degraded"] = [[r.name, r.attrs] for r in obs.records()
                           if r.name in ("metric.sync_state", "collection.step_sync")]
        res["degraded_faults"] = obs.counters_snapshot()["faults"]["degraded_computes"]
    finally:
        sync.set_sync_guard(old)
        obs.disable()
        obs.reset()

    json.dump(res, open(out, "w"))
    dist.destroy_process_group()
""")


def _data():
    rng = np.random.default_rng(16)
    out = []
    for r in range(_WORLD):
        steps = []
        for _ in range(_STEPS):
            p = rng.random((_ROWS[r], _CLASSES))
            p = p / p.sum(1, keepdims=True)
            steps.append((p.astype(np.float32).tolist(), rng.integers(0, _CLASSES, _ROWS[r]).tolist()))
        out.append(steps)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sync_observability")
    data = _data()
    (tmp / "data.json").write_text(json.dumps(data))
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    procs = [
        subprocess.Popen([sys.executable, str(script), str(r), str(tmp / "store"), str(tmp / f"out{r}.json"),
                          str(_REPO), str(tmp / "data.json")],
                         env=dict(os.environ, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for r in range(_WORLD)
    ]
    try:
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * _WORLD, logs
    return data, [json.loads((tmp / f"out{r}.json").read_text()) for r in range(_WORLD)]


def _one_process_epoch(data):
    kw = {"device": "cpu"}
    col = pt.MetricCollection({
        "f1_macro": pt.F1(num_classes=_CLASSES, average="macro", **kw),
        "p_macro": pt.Precision(num_classes=_CLASSES, average="macro", **kw),
        "f1_micro": pt.F1(num_classes=_CLASSES, average="micro", **kw),
        "p_micro": pt.Precision(num_classes=_CLASSES, average="micro", **kw),
        "acc": pt.Accuracy(**kw),
    })
    for r in range(_WORLD):
        for p, t in data[r]:
            col.update(torch.tensor(p, dtype=torch.float32), torch.tensor(t))
    return {k: float(v) for k, v in col.compute().items()}


@pytest.mark.parametrize("host", [False, True])
def test_deferred_epoch_sync_equals_synchronous_in_the_same_collective_order(ranks, host):
    data, results = ranks
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = _one_process_epoch(data)
    for r, res in enumerate(results):
        sync, deferred = res[f"epoch_{host}_False"], res[f"epoch_{host}_True"]
        assert sync["groups"] == [["f1_macro", "p_macro"], ["f1_micro", "p_micro"], ["acc"]]
        assert deferred["values"] == sync["values"], r
        np.testing.assert_allclose(list(sync["values"].values()), [want[k] for k in sync["values"]], rtol=1e-6)
        assert deferred["calls"] == sync["calls"], r
        # one collective a shared group, then the singleton's own sync
        kind = "all_gather" if host else "all_reduce"
        assert [c[0] for c in sync["calls"]] == [kind] * 3, sync["calls"]
        assert deferred["depth"] == {"MetricCollection.epoch": {"current": 0, "max": 2}}
        assert sync["depth"] == {}
        assert [(n, a["group"], a["shared"], a.get("deferred")) for n, a in deferred["spans"]] == [
            ("collection.host_sync", "f1_macro", 2, "yes"), ("collection.host_sync", "f1_micro", 2, "yes")]
        assert all("deferred" not in a for _n, a in sync["spans"]) and len(sync["spans"]) == 2


def test_sync_count_check_raises_on_every_rank_after_a_skipped_compute(ranks):
    _data_, results = ranks
    values = {res["agree_value"] for res in results}
    assert len(values) == 1
    for res in results:
        # the check's one all_gather of the sequence number, then the sync's one bucket
        assert res["agree_calls"] == [["all_gather", "torch.int64", 1], ["all_reduce", "torch.int64", 2]]
        assert "processes disagree on the synced-compute sequence number ([2, 1, 2])" in res["mismatch"]
        assert "Accuracy" in res["mismatch"]


def test_deferred_spans_land_on_their_threads(ranks):
    _data_, results = ranks
    for res in results:
        host = res["lag_host"]
        dispatch = [s for s in host if s[0] == "deferred.dispatch"]
        complete = [s for s in host if s[0] == "deferred.complete"]
        fence = [s for s in host if s[0] == "deferred.fence"]
        assert len(dispatch) == len(complete) == len(fence) == _STEPS
        assert all(t == "main" and a == {"plane": "host_gather", "lag_controller": 1} for _n, t, a in dispatch)
        assert all(t.startswith("mtpu-torch-deferred-host") and a == {"plane": "host_gather"}
                   for _n, t, a in complete)
        assert all(t == "main" and a == {"plane": "host", "label": "host_gather"} for _n, t, a in fence)
        device = res["lag_device"]
        assert sorted({s[0] for s in device}) == ["deferred.dispatch", "deferred.fence"]
        assert all(t == "main" for _n, t, _a in device)
        assert all(a == {"plane": "sync_state", "lag_controller": 1} for n, _t, a in device
                   if n == "deferred.dispatch")


def test_degraded_sync_spans_are_stamped(ranks):
    _data_, results = ranks
    for res in results:
        names = sorted({n for n, a in res["degraded"] if a.get("degraded") == "yes"})
        assert names == ["collection.step_sync", "metric.sync_state"]
        assert all(a.get("degraded") == "yes" for _n, a in res["degraded"])
        assert res["degraded_faults"] == 2 * 2  # two syncs a step (the collection's packed one, Accuracy's), two steps
