"""The windowed plane and the collection's pure view across three real processes (Gloo).

Three ranks over ``torch.distributed`` (Gloo, a FileStore under ``tmp_path``),
uneven batch sizes (one rank with an empty batch in some steps). Every rank's
step carries an event at the step's clock, so the ranks' watermarks, heads and
ring slots stay aligned, as a stream whose producers share one event clock:

* ``Windowed(AUROC(approx="sketch"))`` with ``dist_sync_on_step`` at W = 4 and
  W = 16: each step makes the unwindowed metric's collective calls (one
  ``all_reduce``: the window slabs and the row counts share one int64 sum
  bucket), each step's value is one process's over that step's events of every
  rank, and the synced ``compute()`` equals one process fed every rank's
  events, slab for slab;
* ``MetricCollection([Accuracy, F1, Precision, Recall]).pure().sync`` makes one
  ``all_reduce`` per (dtype, op) bucket of the deduplicated state (one: every
  state is an int64 sum), where the stateful collection's per-step sync makes
  one a compute group (two), and its values equal one process's;
* ``WatermarkAgreement.exchange()`` in a world of 3 agrees on the minimum of
  the three processes' reports (one ``all_reduce``), and a report alone
  dispatches no round.

Tolerances: counts are integers and equal; values from equal counts by the
same math are equal.
"""
import json
import os
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import torch

import metrics_tpu_torch as pt

torch.set_num_threads(1)

_REPO = Path(__file__).resolve().parents[1]
_BINS = 16
_STEPS = 6
_WINDOW_S = 10.0
_CLASSES = 8

_WORKER = textwrap.dedent("""
    import json, sys, warnings
    import numpy as np, torch, torch.distributed as dist
    sys.path.insert(0, {repo!r})
    import metrics_tpu_torch as pt

    warnings.simplefilter("ignore")
    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=3)
    data = json.load(open({data!r}))

    calls = []
    real_gather, real_reduce = dist.all_gather, dist.all_reduce
    dist.all_gather = lambda *a, **k: (calls.append("all_gather"), real_gather(*a, **k))[1]
    dist.all_reduce = lambda *a, **k: (calls.append("all_reduce"), real_reduce(*a, **k))[1]

    result = {{}}
    for w in (4, 16):
        m = pt.Windowed(pt.AUROC(approx="sketch", num_bins={bins}, device="cpu"), window_s={window_s},
                        num_windows=w, allowed_lateness_s=(w - 1) * {window_s}, dist_sync_on_step=True)
        steps = []
        for scores, labels, times in data["windowed"][rank]:
            del calls[:]
            value = m(torch.tensor(scores, dtype=torch.float32), torch.tensor(labels), event_time=np.asarray(times))
            steps.append({{"value": float(value), "calls": list(calls)}})
        del calls[:]
        epoch = float(m.compute())
        result[f"w{{w}}"] = {{"steps": steps, "epoch": epoch, "epoch_calls": list(calls),
                              "synced": {{n: (v.counts if hasattr(v, "counts") else v).tolist()
                                          for n, v in m._synced_state().items()}},
                              "dropped": m.dropped_samples, "resident": list(m.resident_windows())}}
    unwindowed = pt.AUROC(approx="sketch", num_bins={bins}, device="cpu", dist_sync_on_step=True)
    scores, labels, _ = data["windowed"][rank][0]
    del calls[:]
    unwindowed(torch.tensor(scores, dtype=torch.float32), torch.tensor(labels))
    result["unwindowed_calls"] = list(calls)

    col = pt.MetricCollection([pt.Accuracy(device="cpu"),
                               pt.F1(num_classes={classes}, average="macro", device="cpu"),
                               pt.Precision(num_classes={classes}, average="macro", device="cpu"),
                               pt.Recall(num_classes={classes}, average="macro", device="cpu")])
    pure = col.pure()
    state = pure.init()
    for probs, classes in data["collection"][rank]:
        state = pure.update(state, torch.tensor(probs, dtype=torch.float32), torch.tensor(classes))
    del calls[:]
    synced = pure.sync(state)
    result["pure"] = {{"calls": list(calls), "entries": sorted(state),
                       "values": {{k: float(v) for k, v in pure.compute(synced).items()}},
                       "own": int(col["F1"].tp.sum())}}
    stepper = pt.MetricCollection([pt.Accuracy(device="cpu", dist_sync_on_step=True),
                                   pt.F1(num_classes={classes}, average="macro", device="cpu", dist_sync_on_step=True),
                                   pt.Precision(num_classes={classes}, average="macro", device="cpu",
                                                dist_sync_on_step=True),
                                   pt.Recall(num_classes={classes}, average="macro", device="cpu",
                                             dist_sync_on_step=True)])
    probs, classes = data["collection"][rank][0]
    del calls[:]
    stepper(torch.tensor(probs, dtype=torch.float32), torch.tensor(classes))
    result["step_calls"] = list(calls)

    ag = pt.WatermarkAgreement(deadline_s=30.0, exchange_every_s=3600.0)
    del calls[:]
    ag.report(rank, 10.0 * (rank + 1))
    report_calls = list(calls)
    ag.exchange().result()
    result["exchange"] = {{"agreed": ag.agreed(), "report_calls": report_calls, "calls": list(calls),
                          "exchanges": ag.exchanges}}
    json.dump(result, open(out, "w"))
    dist.destroy_process_group()
""")

# events a rank holds each step (0: an empty batch on that rank but for the clock event)
_SIZES = [[40, 12, 30, 0, 25, 33], [18, 0, 22, 41, 9, 14], [0, 27, 8, 16, 30, 5]]


def _windowed_batch(seed, step, n):
    """``n`` events of step ``step`` plus the step's clock event (every rank holds
    it): 20% late by up to 2 windows, 5% beyond every ring's lateness."""
    rng = np.random.RandomState(seed)
    clock = (step + 1) * 0.8 * _WINDOW_S
    times = clock - rng.uniform(0, 0.8 * _WINDOW_S, n)
    late = rng.rand(n) < 0.2
    times[late] -= rng.uniform(0, 2 * _WINDOW_S, late.sum())
    drop = rng.rand(n) < 0.05
    times[drop] -= 20 * _WINDOW_S
    times = np.append(times, clock)
    labels = (rng.rand(n + 1) < 0.4).astype(np.int64)
    scores = (1 / (1 + np.exp(-(rng.randn(n + 1) + labels)))).astype(np.float32)
    return [scores.tolist(), labels.tolist(), times.tolist()]


def _collection_batch(seed, n):
    rng = np.random.RandomState(seed)
    logits = rng.randn(n, _CLASSES)
    probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)
    return [probs.tolist(), rng.randint(0, _CLASSES, n).tolist()]


def _one_process_windowed(batches_per_step, w):
    m = pt.Windowed(pt.AUROC(approx="sketch", num_bins=_BINS, device="cpu"), window_s=_WINDOW_S, num_windows=w,
                    allowed_lateness_s=(w - 1) * _WINDOW_S)
    values = []
    for rows in batches_per_step:
        scores = np.concatenate([np.float32(r[0]) for r in rows])
        labels = np.concatenate([np.int64(r[1]) for r in rows])
        times = np.concatenate([np.float64(r[2]) for r in rows])
        values.append(float(m(torch.from_numpy(scores), torch.from_numpy(labels), event_time=times)))
    return m, values


def test_three_rank_gloo_windowed_and_pure_collection_sync(tmp_path):
    windowed = [[_windowed_batch(100 * r + s, s, n) for s, n in enumerate(sizes)] for r, sizes in enumerate(_SIZES)]
    collection = [[_collection_batch(500 + 10 * r + i, n) for i, n in enumerate((50, 17))] for r in range(3)]
    data = tmp_path / "batches.json"
    data.write_text(json.dumps({"windowed": windowed, "collection": collection}))
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=str(_REPO), data=str(data), bins=_BINS, window_s=_WINDOW_S,
                                     classes=_CLASSES))
    procs = [
        subprocess.Popen([sys.executable, str(script), str(r), str(tmp_path / "store"), str(tmp_path / f"out{r}.json")],
                         env=dict(os.environ, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
        for r in range(3)
    ]
    try:
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0, 0], logs
    results = [json.loads((tmp_path / f"out{r}.json").read_text()) for r in range(3)]

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        per_step = [[windowed[r][s] for r in range(3)] for s in range(_STEPS)]
        for w in (4, 16):
            one, step_values = _one_process_windowed(per_step, w)
            want_state = {n: (v.counts if hasattr(v, "counts") else v).tolist() for n, v in one._current_state().items()}
            for r, res in enumerate(results):
                run = res[f"w{w}"]
                assert [s["calls"] for s in run["steps"]] == [res["unwindowed_calls"]] * _STEPS == \
                    [["all_reduce"]] * _STEPS, (r, w)
                assert [s["value"] for s in run["steps"]] == step_values, (r, w)
                assert run["synced"] == want_state, (r, w)
                assert run["epoch"] == float(one.compute()) and run["epoch_calls"] == ["all_reduce"]
                assert run["resident"][-1] == one.resident_windows()[-1]  # the same head on every rank
            # every rank's drops sum to the one process's; its origin is the oldest of the ranks'
            assert sum(res[f"w{w}"]["dropped"] for res in results) == one.dropped_samples > 0
            assert min(res[f"w{w}"]["resident"][0] for res in results) == one.resident_windows()[0]

        col = pt.MetricCollection([pt.Accuracy(device="cpu"),
                                   pt.F1(num_classes=_CLASSES, average="macro", device="cpu"),
                                   pt.Precision(num_classes=_CLASSES, average="macro", device="cpu"),
                                   pt.Recall(num_classes=_CLASSES, average="macro", device="cpu")])
        for rank in collection:
            for probs, classes in rank:
                col.update(torch.tensor(probs, dtype=torch.float32), torch.tensor(classes))
        want = {k: float(v) for k, v in col.compute().items()}
    for r, res in enumerate(results):
        pure = res["pure"]
        assert pure["entries"] == ["Accuracy", "F1"] and pure["own"] == 0
        assert pure["calls"] == ["all_reduce"], r  # one int64 sum bucket for the whole collection
        assert res["step_calls"] == ["all_reduce", "all_reduce"]  # the stateful per-step sync: one a group
        assert pure["values"] == want, r
        assert res["exchange"] == {"agreed": 10.0, "report_calls": [], "calls": ["all_reduce"], "exchanges": 1}
