"""The guarded and deferred sync plane across three real processes (Gloo).

Three ranks over ``torch.distributed`` (Gloo, a FileStore under ``tmp_path``),
each fed its own seeded batches. Every fault schedule is installed on every
rank, as the JAX package's chaos matrix does, so every rank retries, degrades
or raises at the same call:

* ``Accuracy`` (one int64 sum bucket: one ``all_reduce`` a sync) with
  ``dist_sync_on_step``: a transient drop x2 records 2 retries and gives the
  unfaulted values bit for bit; a corrupted payload under
  ``check_finite=True`` is retried to the same values; a persistent drop under
  ``policy="degrade"`` gives the local values (``degraded_computes`` counted)
  and under ``"raise"`` raises ``SyncTimeoutError``; a real late peer (rank 2
  enters 0.5 s late, the deadline is 0.05 s) is waited out by re-waiting the
  same work, with the unfaulted values;
* the gather plane (``AUROC`` list states): a dropped layout gather is
  retried; a data gather that degrades gives the local value;
* one rank degrading alone (rank 2 enters 2 s late, ranks 0 and 1 wait
  0.1 s twice): at the layout table (``AUROC``), at a sum bucket and at a
  deferred dispatch (a sum and a list state, the list appended to after
  dispatch), the degraded ranks get their local values, the late rank gets
  every rank's, and the next unguarded syncs are right on every rank;
* ``sync_lag`` = 1, 2, 3 over the bucketed ``all_reduce`` plane: each step's
  value is the synchronous run's value k steps back, and the epoch equals one
  process fed every rank's batches (the port's and the JAX package's);
* ``sync_state(deferred=True)``: the device handle equals the synchronous
  sync, and a ``Keyed`` state written in place after dispatch does not change
  its result; the collection's deferred handle resolves to the nested state;
* ``WatermarkAgreement.exchange()`` across the three processes: the ranks
  agree on the minimum (rank 2 runs 90 s behind), a silent participant is
  excluded past its deadline (``wm_stragglers`` + 1) and the others' clock
  advances, and it rejoins on its next report.

Every child is killed if it outlives its timeout; this process never joins a
group. Tolerances: counts are integers and equal; values from equal counts
by the same arithmetic are equal.
"""
import json
import os
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

import metrics_tpu as mt
import metrics_tpu_torch as pt
from tests.test_torch_faults import plane_hygiene  # noqa: F401  (autouse: every test leaves the process clean)

torch.set_num_threads(1)

_REPO = Path(__file__).resolve().parents[1]
_STEPS = 6
_ROWS = (20, 33, 12)

_WORKER = textwrap.dedent("""
    import contextlib, json, sys, time, warnings
    import numpy as np, torch, torch.distributed as dist
    sys.path.insert(0, sys.argv[4])
    import metrics_tpu_torch as pt
    from metrics_tpu_torch.observability import counters
    from metrics_tpu_torch.parallel import deferred as pdeferred, faults, sync
    from metrics_tpu_torch.utils.exceptions import SyncTimeoutError

    warnings.simplefilter("ignore")
    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=3)
    data = json.load(open(sys.argv[5]))
    batches = [(torch.tensor(p, dtype=torch.float32), torch.tensor(t)) for p, t in data["acc"][rank]]
    result = {}

    calls = []
    real_reduce, real_gather = dist.all_reduce, dist.all_gather
    dist.all_reduce = lambda *a, **k: (calls.append("all_reduce"), real_reduce(*a, **k))[1]
    dist.all_gather = lambda *a, **k: (calls.append("all_gather"), real_gather(*a, **k))[1]

    def acc_run(guard=None, specs=(), lag=0, late=0.0):
        counters.reset()
        m = pt.Accuracy(device="cpu", dist_sync_on_step=True)
        m.sync_lag = lag
        old = sync.set_sync_guard(guard)
        try:
            with faults.ChaosInjector([faults.FaultSpec(**s) for s in specs], seed=1) if specs else \
                    contextlib.nullcontext():
                values = []
                for i, b in enumerate(batches):
                    if late and rank == 2 and i == 1:
                        time.sleep(late)
                    values.append(float(m(*b)))
                epoch = float(m.compute())
        except SyncTimeoutError as err:
            return {"raised": type(err).__name__}
        finally:
            sync.set_sync_guard(old)
        return {"values": values, "epoch": epoch, "faults": counters.snapshot()["faults"]}

    del calls[:]
    result["clean"] = acc_run()
    result["clean_calls"] = len(calls)
    result["drop2"] = acc_run(sync.SyncGuard(max_retries=2, backoff_s=0.01), [dict(kind="drop", call=1, times=2)])
    result["corrupt"] = acc_run(sync.SyncGuard(max_retries=2, backoff_s=0.01, check_finite=True),
                                [dict(kind="corrupt", call=2, times=1)])
    result["degrade"] = acc_run(sync.SyncGuard(max_retries=1, backoff_s=0.01, policy="degrade"),
                                [dict(kind="drop", rate=1.0, times=10**6)])
    result["raise"] = acc_run(sync.SyncGuard(max_retries=1, backoff_s=0.01), [dict(kind="drop", call=0, times=99)])
    result["late_peer"] = acc_run(sync.SyncGuard(deadline_s=0.05, max_retries=100, backoff_s=0.0), late=0.5)
    result["local"] = [float(pt.Accuracy(device="cpu")(*b)) for b in batches]
    for k in (1, 2, 3):
        result[f"lag{k}"] = acc_run(lag=k)

    # the gather plane: AUROC's list states, synced at compute()
    scores, labels = data["auroc"][rank]
    def auroc(specs=(), guard=None):
        counters.reset()
        m = pt.AUROC(device="cpu")
        m.update(torch.tensor(scores, dtype=torch.float32), torch.tensor(labels))
        old = sync.set_sync_guard(guard)
        try:
            with faults.ChaosInjector([faults.FaultSpec(**s) for s in specs], seed=1):
                return {"value": float(m.compute()), "faults": counters.snapshot()["faults"]}
        finally:
            sync.set_sync_guard(old)
    result["auroc_clean"] = auroc()
    result["auroc_drop"] = auroc([dict(kind="drop", call=0, times=1)], sync.SyncGuard(backoff_s=0.01))
    result["auroc_degrade"] = auroc([dict(kind="drop", call=1, times=99)],
                                    sync.SyncGuard(max_retries=1, backoff_s=0.01, policy="degrade"))
    local = pt.AUROC(device="cpu")
    local.update(torch.tensor(scores, dtype=torch.float32), torch.tensor(labels))
    local.dist_sync_fn = lambda v: [v]
    result["auroc_local"] = float(local.compute())

    # one rank degrades alone: rank 2 enters each sync 2 s late, ranks 0 and 1 give up on it after two
    # 0.1 s waits; they still enter every padded gather rank 2 enters, so the next syncs pair up
    lone_guard = sync.SyncGuard(deadline_s=30.0 if rank == 2 else 0.1, max_retries=1, backoff_s=0.0,
                                policy="degrade")
    mixed = lambda: {"total": torch.tensor([rank + 1]), "rows": [torch.arange(rank + 2, dtype=torch.float32)]}
    mixed_fx = {"total": "sum", "rows": "cat"}
    plain = lambda out: {"total": out["total"].tolist(), "rows": out["rows"].tolist()}
    counters.reset()
    old = sync.set_sync_guard(lone_guard)
    try:
        lone = pt.AUROC(device="cpu")
        lone.update(torch.tensor(scores, dtype=torch.float32), torch.tensor(labels))
        dist.barrier()
        time.sleep(2.0 if rank == 2 else 0.0)
        lone_value = float(lone.compute())  # degrades at the layout table
        dist.barrier()
        time.sleep(2.0 if rank == 2 else 0.0)
        lone_sync = plain(sync.all_reduce_state(mixed(), mixed_fx))  # degrades at the sum bucket
        dist.barrier()
        time.sleep(2.0 if rank == 2 else 0.0)
        state = mixed()
        pending = sync.dispatch_state_sync(state, mixed_fx, deferred=True)  # degrades at the table, at dispatch
        state["rows"].append(torch.full((3,), 9.0))  # written after dispatch: the local view is the snapshot
        lone_deferred = plain(pending.finish())
        lone_faults = counters.snapshot()["faults"]
    finally:
        sync.set_sync_guard(old)
    after = pt.AUROC(device="cpu")
    after.update(torch.tensor(scores, dtype=torch.float32), torch.tensor(labels))
    result["lone"] = {"auroc": lone_value, "sync": lone_sync, "deferred": lone_deferred, "faults": lone_faults,
                      "next_auroc": float(after.compute()),
                      "next_sync": plain(sync.all_reduce_state(mixed(), mixed_fx))}

    # the deferred device handle, on a state written in place after dispatch
    keyed = pt.Keyed(pt.MeanSquaredError(device="cpu"), num_slots=5)
    p, t, s = data["keyed"][rank]
    keyed.update(torch.tensor(p, dtype=torch.float32), torch.tensor(t, dtype=torch.float32), slot=torch.tensor(s))
    want = keyed.sync_state(keyed._current_state())
    rows = keyed.keyed_rows.clone()
    del calls[:]
    handle = keyed.sync_state(keyed._current_state(), deferred=True)
    dispatch_calls = list(calls)
    keyed.update(torch.tensor(p, dtype=torch.float32), torch.tensor(t, dtype=torch.float32), slot=torch.tensor(s))
    got = handle.result()
    bound = pdeferred.DeferredSyncPlane(keyed._reductions, device=keyed.device).dispatch(want, watermark=5)
    again = bound.result()
    result["plane"] = {"equal": all(torch.equal(again[n], 3 * want[n]) for n in want if n != "keyed_rows")
                       and torch.equal(again["keyed_rows"], 3 * want["keyed_rows"]), "watermark": bound.watermark}
    result["deferred"] = {"equal": all(torch.equal(got[n], want[n]) for n in want), "calls": dispatch_calls,
                          "watermark": handle.watermark, "live_moved": torch.equal(keyed.keyed_rows, 2 * rows)}
    col = pt.MetricCollection([pt.Accuracy(device="cpu"), pt.Precision(device="cpu")])
    pure = col.pure()
    nested = col.sync_state(pure.update(pure.init(), *batches[0]), deferred=True).result()
    result["collection"] = {k: {n: v.tolist() for n, v in s.items()} for k, s in nested.items()}

    # the watermark agreement across the processes: rank 2 runs 90 s behind
    ag = pt.WatermarkAgreement(deadline_s=1.5, guard=sync.SyncGuard(deadline_s=30.0))
    me = f"p{rank}"
    ag.register(me)
    ag.report(me, 1000.0 - 90.0 * (rank == 2) + rank)
    ag.exchange().result()
    agreement = {"first": ag.agreed(), "local": ag.local_watermarks()[me]}
    if rank != 1:
        ag.report(me, 1500.0 + rank)
    stragglers = counters.snapshot()["wm_stragglers"]
    time.sleep(2.0)  # past p1's deadline; p0 and p2 keep advancing
    if rank != 1:
        ag.report(me, 1600.0 + rank)
    ag.exchange().result()
    agreement["silent"] = {"agreed": ag.agreed(), "excluded": list(ag.excluded()),
                           "stragglers": counters.snapshot()["wm_stragglers"] - stragglers}
    if rank == 1:
        ag.report(me, 1550.0)
    ag.exchange().result()
    agreement["rejoined"] = {"agreed": ag.agreed(), "excluded": list(ag.excluded()), "exchanges": ag.exchanges}
    result["agreement"] = agreement

    json.dump(result, open(out, "w"))
    dist.destroy_process_group()
""")


def _data():
    rng = np.random.RandomState(17)
    acc = [[(rng.rand(n).tolist(), rng.randint(0, 2, n).tolist()) for _ in range(_STEPS)] for n in _ROWS]
    auroc = [(rng.rand(n).tolist(), rng.randint(0, 2, n).tolist()) for n in (40, 25, 31)]
    keyed = [(rng.rand(n).tolist(), rng.rand(n).tolist(), rng.randint(0, 5, n).tolist()) for n in (9, 14, 6)]
    return {"acc": acc, "auroc": auroc, "keyed": keyed}


def _one_process_acc(data):
    """Per-step synced values and the epoch of one process fed every rank's batches, in both packages."""
    port, ref = pt.Accuracy(device="cpu"), mt.Accuracy()
    steps, jsteps = [], []
    for s in range(_STEPS):
        p = np.concatenate([np.float32(data["acc"][r][s][0]) for r in range(3)])
        t = np.concatenate([np.int64(data["acc"][r][s][1]) for r in range(3)])
        steps.append(float(port(torch.from_numpy(p), torch.from_numpy(t))))
        jsteps.append(float(ref(jnp.asarray(p), jnp.asarray(t.astype(np.int32)))))
    return steps, jsteps, float(port.compute()), float(ref.compute())


def test_three_rank_gloo_guarded_and_deferred_sync(tmp_path):
    data = _data()
    (tmp_path / "data.json").write_text(json.dumps(data))
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    procs = [
        subprocess.Popen([sys.executable, str(script), str(r), str(tmp_path / "store"), str(tmp_path / f"out{r}.json"),
                          str(_REPO), str(tmp_path / "data.json")],
                         env=dict(os.environ, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for r in range(3)
    ]
    try:
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0, 0], logs
    results = [json.loads((tmp_path / f"out{r}.json").read_text()) for r in range(3)]

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        steps, jsteps, epoch, jepoch = _one_process_acc(data)
    assert steps == jsteps and epoch == jepoch
    zero = {"sync_retries": 0, "sync_deadline_exceeded": 0, "degraded_computes": 0, "quarantined_updates": 0}
    for r, res in enumerate(results):
        clean = res["clean"]
        assert clean["values"] == steps and clean["epoch"] == epoch and clean["faults"] == zero, r
        assert res["clean_calls"] == _STEPS + 1  # one all_reduce a step and one at the epoch: one bucket
        assert res["drop2"]["values"] == steps and res["drop2"]["epoch"] == epoch
        assert res["drop2"]["faults"] == dict(zero, sync_retries=2), r
        assert res["corrupt"]["values"] == steps and res["corrupt"]["faults"] == dict(zero, sync_retries=1), r
        assert res["degrade"]["values"] == res["local"], r  # local-only values, no stall
        assert res["degrade"]["faults"]["degraded_computes"] == _STEPS + 1
        assert res["raise"] == {"raised": "SyncTimeoutError"}
        late = res["late_peer"]
        assert late["values"] == steps and late["epoch"] == epoch and late["faults"]["degraded_computes"] == 0
        if r != 2:
            assert late["faults"]["sync_retries"] >= 1, r  # waited the late peer out on the same work
        for k in (1, 2, 3):
            lag = res[f"lag{k}"]
            assert lag["values"] == [steps[i - k] if i >= k else res["local"][i] for i in range(_STEPS)], (r, k)
            assert lag["epoch"] == epoch == jepoch, (r, k)
        assert res["auroc_drop"]["value"] == res["auroc_clean"]["value"]
        assert res["auroc_drop"]["faults"]["sync_retries"] == 1
        assert res["auroc_degrade"]["value"] == res["auroc_local"]
        assert res["auroc_degrade"]["faults"]["degraded_computes"] == 1
        lone = res["lone"]
        full = {"total": [6], "rows": [0.0, 1.0, 0.0, 1.0, 2.0, 0.0, 1.0, 2.0, 3.0]}
        own = {"total": [r + 1], "rows": [float(i) for i in range(r + 2)]}
        if r == 2:  # the late rank waited for nothing and got every rank's rows
            assert lone["auroc"] == res["auroc_clean"]["value"] and lone["sync"] == lone["deferred"] == full
            assert lone["faults"]["degraded_computes"] == 0
        else:
            assert lone["auroc"] == res["auroc_local"] and lone["sync"] == lone["deferred"] == own, r
            assert lone["faults"]["degraded_computes"] == 3 and lone["faults"]["sync_deadline_exceeded"] == 3, r
        # the next syncs pair up on every rank: no collective was left unentered
        assert lone["next_auroc"] == res["auroc_clean"]["value"] and lone["next_sync"] == full, r
        deferred = res["deferred"]
        # two buckets (float32 and int64 sums), entered at dispatch; the in-place update did land
        assert deferred["equal"] and deferred["calls"] == ["all_reduce"] * 2 and deferred["live_moved"], r
        assert deferred["watermark"] == 1
        assert res["plane"] == {"equal": True, "watermark": 5}  # DeferredSyncPlane: the synced state summed again
        assert res["collection"] == results[0]["collection"]
        ag = res["agreement"]
        assert ag["first"] == 910.0 + 2, r  # the minimum: rank 2's clock, 90 s behind
        if r == 1:
            assert ag["silent"]["excluded"] == ["p1"] and ag["silent"]["stragglers"] == 1
            assert ag["silent"]["agreed"] == 912.0  # its own registry holds no included rank: the clock holds
        else:
            assert ag["silent"]["excluded"] == [] and ag["silent"]["agreed"] == 1600.0  # p1 no longer holds it back
        assert ag["rejoined"]["excluded"] == [] and ag["rejoined"]["exchanges"] == 3
        assert ag["rejoined"]["agreed"] == (1550.0 if r == 1 else 1600.0), r
    auroc_one = pt.AUROC(device="cpu")
    for s, lab in data["auroc"]:
        auroc_one.update(torch.tensor(s, dtype=torch.float32), torch.tensor(lab))
    assert all(res["auroc_clean"]["value"] == float(auroc_one.compute()) for res in results)
    one = pt.MetricCollection([pt.Accuracy(device="cpu"), pt.Precision(device="cpu")])
    one.update(torch.tensor(np.concatenate([data["acc"][r][0][0] for r in range(3)]), dtype=torch.float32),
               torch.tensor(np.concatenate([data["acc"][r][0][1] for r in range(3)])))
    for k, states in results[0]["collection"].items():
        assert states == {n: v.tolist() for n, v in one[k]._current_state().items()}, k
