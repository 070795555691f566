"""Sketch states synced across three real processes (Gloo), against one process over all rows.

Three ranks over ``torch.distributed`` (Gloo, a FileStore under ``tmp_path``)
with uneven batch counts and sizes, and one rank with no update at all:

* curve sketches (AUROC / AveragePrecision / ROC / PrecisionRecallCurve with
  ``approx="sketch"``, one compute group, and AUROC / AveragePrecision with
  ``approx="qsketch"``, another), rank sketches (Spearman / Kendall, one
  group), the quantile family (Quantile / Percentile, one group),
  MedianAbsoluteError and a count-min state declared with ``add_state``;
* the synced counts equal one process's counts over every rank's rows bit for
  bit, the rank with no update joins with zeros and keeps its own (zero) state,
  and every value equals the one-process value;
* each compute group syncs with one ``all_reduce`` (its one int64 sum bucket),
  and with ``dist_sync_on_step`` every step makes one update and one
  ``all_reduce`` for the group, its value the one-process value over that
  step's rows of every rank.

Tolerances: counts are integers and equal; values come from equal counts by
the same float64 math on every rank and in the one process, so they are equal.
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

_COMMON = """
import metrics_tpu_torch as pt
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.parallel.cms import CMSSpec, CountMinSketch, cms_buckets, cms_scatter, cms_total
from metrics_tpu_torch.parallel.cms import stable_key_hash_array


class KeyCounts(Metric):
    def __init__(self, **kw):
        super().__init__(device="cpu", **kw)
        self.add_state("tail", default=CMSSpec(4, 64, (), torch.int64, seed=29), dist_reduce_fx="sum")

    def update(self, keys):
        buckets = torch.from_numpy(cms_buckets(stable_key_hash_array(keys.numpy()), 4, 64, 29))
        self.tail = CountMinSketch(cms_scatter(self.tail.counts, buckets, torch.ones(len(keys), dtype=torch.int64)))

    def compute(self):
        return cms_total(self.tail.counts)


def collections():
    cpu = dict(device="cpu")
    return {
        "curves": pt.MetricCollection({
            "auroc": pt.AUROC(approx="sketch", num_bins=64, **cpu), "ap": pt.AveragePrecision(approx="sketch", num_bins=64, **cpu),
            "roc": pt.ROC(approx="sketch", num_bins=64, **cpu), "prc": pt.PrecisionRecallCurve(approx="sketch", num_bins=64, **cpu),
            "q_auroc": pt.AUROC(approx="qsketch", **cpu), "q_ap": pt.AveragePrecision(approx="qsketch", **cpu)}),
        "ranks": pt.MetricCollection({"spearman": pt.SpearmanCorrcoef(approx="sketch", **cpu),
                                      "kendall": pt.KendallRankCorrCoef(approx="sketch", **cpu)}),
        "quantiles": pt.MetricCollection({"p50": pt.Quantile(q=(0.5, 0.9), **cpu), "p99": pt.Percentile(99, **cpu)}),
        "mae": pt.MetricCollection({"mae": pt.MedianAbsoluteError(**cpu)}),
        "keys": pt.MetricCollection({"key_counts": KeyCounts()}),
    }


def feed(cols, batch):
    scores, labels, preds, target, keys = (torch.tensor(x) for x in batch)
    cols["curves"].update(scores, labels)
    cols["ranks"].update(preds, target)
    cols["quantiles"].update(preds)
    cols["mae"].update(preds, target)
    cols["keys"].update(keys)


def plain(v):
    if isinstance(v, (list, tuple)):
        return [plain(x) for x in v]
    return v.tolist()
"""

_WORKER = textwrap.dedent("""
    import json, sys, warnings
    import numpy as np, torch, torch.distributed as dist
    sys.path.insert(0, {repo!r})
    exec(open({common!r}).read())

    warnings.simplefilter("ignore")
    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=3)
    data = json.load(open({data!r}))

    calls = []
    real_gather, real_reduce = dist.all_gather, dist.all_reduce
    dist.all_gather = lambda *a, **k: (calls.append("all_gather"), real_gather(*a, **k))[1]
    dist.all_reduce = lambda *a, **k: (calls.append("all_reduce"), real_reduce(*a, **k))[1]

    cols = collections()
    for batch in data["epoch"][rank]:
        feed(cols, batch)
    result = {{"values": {{}}, "calls": {{}}, "synced": {{}}, "local": {{}}, "steps": []}}
    for name, col in cols.items():
        del calls[:]
        result["values"][name] = {{k: plain(v) for k, v in col.compute().items()}}
        result["calls"][name] = list(calls)
        for rep in col.compute_groups:
            state = col[rep]._synced_state()
            result["synced"][rep] = {{k: v.counts.tolist() for k, v in state.items()}}
            result["local"][rep] = {{k: int(v.counts.sum()) for k, v in col[rep]._current_state().items()}}

    updates = []
    real_update = Metric._run_update_on_state
    Metric._run_update_on_state = lambda self, *a, **k: (updates.append(1), real_update(self, *a, **k))[1]
    stepper = pt.MetricCollection([pt.AUROC(approx="sketch", num_bins=64, dist_sync_on_step=True, device="cpu"),
                                   pt.AveragePrecision(approx="sketch", num_bins=64, dist_sync_on_step=True,
                                                       device="cpu")])
    for scores, labels in data["steps"][rank]:
        del calls[:]
        out_step = stepper(torch.tensor(scores, dtype=torch.float32), torch.tensor(labels))
        result["steps"].append({{"values": {{k: v.item() for k, v in out_step.items()}}, "calls": list(calls)}})
    result["step_updates"] = len(updates)
    json.dump(result, open(out, "w"))
    dist.destroy_process_group()
""")

# rank 0: three batches, rank 1: one, rank 2: no update at all
_SIZES = [[40, 23, 9], [31], []]
# dist_sync_on_step: every rank steps together; a 0 is an empty batch on that rank
_STEP_SIZES = [[16, 5, 0], [8, 0, 7], [0, 3, 12]]


def _batch(seed, n):
    rng = np.random.RandomState(seed)
    labels = (rng.rand(n) < 0.4).astype(np.int64)
    scores = (1 / (1 + np.exp(-(rng.randn(n) + labels)))).astype(np.float32)
    if n:
        scores[0] = np.nan
    target = np.exp(rng.randn(n)).astype(np.float32)
    preds = (target * np.exp(0.2 * rng.randn(n))).astype(np.float32)
    keys = rng.zipf(1.3, n) % 50
    return [scores.tolist(), labels.tolist(), preds.tolist(), target.tolist(), keys.tolist()]


def test_three_rank_gloo_sketch_sync_equals_one_process(tmp_path):
    epoch = [[_batch(10 * r + i, n) for i, n in enumerate(sizes)] for r, sizes in enumerate(_SIZES)]
    steps = [[_batch(100 + 10 * r + i, n)[:2] for i, n in enumerate(sizes)] for r, sizes in enumerate(_STEP_SIZES)]
    data = tmp_path / "batches.json"
    data.write_text(json.dumps({"epoch": epoch, "steps": steps}))
    common = tmp_path / "common.py"
    common.write_text(_COMMON)
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=str(_REPO), common=str(common), data=str(data)))
    procs = [
        subprocess.Popen([sys.executable, str(script), str(r), str(tmp_path / "store"), str(tmp_path / f"out{r}.json")],
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

    namespace = {"torch": torch}
    exec(_COMMON, namespace)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        one = namespace["collections"]()
    for batch in (b for rank in epoch for b in rank):
        namespace["feed"](one, batch)
    plain = namespace["plain"]
    want = {name: {k: plain(v) for k, v in col.compute().items()} for name, col in one.items()}
    groups = {rep: col[rep] for col in one.values() for rep in col.compute_groups}
    assert sorted(groups) == ["auroc", "key_counts", "mae", "p50", "q_auroc", "spearman"]

    for r, res in enumerate(results):
        assert res["values"] == want, f"rank {r}"
        for rep, metric in groups.items():
            for state, counts in metric._current_state().items():
                assert res["synced"][rep][state] == counts.counts.tolist(), f"rank {r} {rep}.{state}"
        # one all_reduce a compute group: the curves' two groups, and one for each other collection
        assert res["calls"] == {"curves": ["all_reduce"] * 2, "ranks": ["all_reduce"], "quantiles": ["all_reduce"],
                                "mae": ["all_reduce"], "keys": ["all_reduce"]}
        if r == 2:  # no update: the rank joined with zeros and kept its own state
            assert all(n == 0 for local in res["local"].values() for n in local.values())

        # dist_sync_on_step: one update and one all_reduce a step, the value over that step's rows of every rank
        assert res["step_updates"] == len(_STEP_SIZES[r])
        for step in range(3):
            scores = np.concatenate([np.float32(steps[q][step][0]) for q in range(3)])
            labels = np.concatenate([np.int64(steps[q][step][1]) for q in range(3)])
            ref = pt.MetricCollection([pt.AUROC(approx="sketch", num_bins=64, device="cpu"),
                                       pt.AveragePrecision(approx="sketch", num_bins=64, device="cpu")])
            expect = {k: v.item() for k, v in ref(torch.from_numpy(scores), torch.from_numpy(labels)).items()}
            assert res["steps"][step]["values"] == expect
            assert res["steps"][step]["calls"] == ["all_reduce"]
