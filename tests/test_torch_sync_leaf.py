"""Detection, clustering and nominal states synced across three real processes (Gloo).

Three ranks over ``torch.distributed`` (Gloo, a FileStore under ``tmp_path``),
with uneven work: rank 0 several batches, rank 1 one image / one small batch,
rank 2 no update at all. Against one process fed every rank's rows in rank
order:

* ``MeanAveragePrecision``'s eight list states gather (the rank with no image
  joins with its declared item shapes) and every result key equals the one
  process's, with list states and with ``capacity=``;
* ``DaviesBouldinScore`` gathers its samples in list and ``capacity=`` modes;
* ``CalinskiHarabaszScore``'s moment block folds across ranks with the
  associative Chan merge;
* the contingency family (Rand, AMI, Cramer's V) sums its int64 state with one
  ``all_reduce`` a metric, equal to the one process's counts bit for bit.

Tolerances: gathered states hold the same rows in the same order, so mAP, DB
and the contingency scores equal the one-process values exactly; CH's Chan
merges run in another grouping (rank states folded, not one batch after
another): rtol 1e-6.
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

torch.set_num_threads(1)

_REPO = Path(__file__).resolve().parents[1]

_COMMON = """
import numpy as np
import torch
import metrics_tpu_torch as pt


def collections():
    cpu = dict(device="cpu")
    return {
        "map": pt.MetricCollection({"map": pt.MeanAveragePrecision(num_classes=3, max_detections=12, max_gt=8,
                                                                   class_metrics=True, **cpu)}),
        "map_cap": pt.MetricCollection({"map": pt.MeanAveragePrecision(num_classes=3, max_detections=12, max_gt=8,
                                                                       class_metrics=True, capacity=16, **cpu)}),
        "db": pt.MetricCollection({"db": pt.DaviesBouldinScore(4, **cpu)}),
        "db_cap": pt.MetricCollection({"db": pt.DaviesBouldinScore(4, capacity=256, **cpu)}),
        "ch": pt.MetricCollection({"ch": pt.CalinskiHarabaszScore(4, 3, **cpu)}),
        "cont": pt.MetricCollection({"rand": pt.RandScore(5, 4, **cpu), "ami": pt.AdjustedMutualInfoScore(5, 4, **cpu),
                                     "cramers": pt.CramersV(5, 4, **cpu)}),
    }


def feed(cols, batch):
    if batch["images"]:
        preds = [{k: torch.tensor(v) for k, v in d.items()} for d in batch["images"]["preds"]]
        target = [{k: torch.tensor(v) for k, v in g.items()} for g in batch["images"]["target"]]
        cols["map"].update(preds, target)
        cols["map_cap"].update(preds, target)
    data, labels = torch.tensor(batch["data"], dtype=torch.float32), torch.tensor(batch["labels"])
    for name in ("db", "db_cap", "ch"):
        cols[name].update(data, labels)
    cols["cont"].update(torch.tensor(batch["preds"]), torch.tensor(batch["target"]))


def plain(v):
    if isinstance(v, dict):
        return {k: plain(x) for k, x in v.items()}
    return v.tolist()


def flat(values, prefix=""):
    out = {}
    for k, v in values.items():
        if isinstance(v, dict):
            out.update(flat(v, prefix + k + "."))
        else:
            out[prefix + k] = v
    return out
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
    for batch in data[rank]:
        feed(cols, batch)
    result = {{"values": {{}}, "calls": {{}}}}
    for name, col in cols.items():
        del calls[:]
        result["values"][name] = flat({{k: plain(v) for k, v in col.compute().items()}})
        result["calls"][name] = sorted(set(calls))
    result["contingency"] = cols["cont"]["rand"]._synced_state()["contingency"].tolist()
    json.dump(result, open(out, "w"))
    dist.destroy_process_group()
""")


def _image(rng):
    n_det, n_gt = int(rng.integers(0, 12)), int(rng.integers(1, 8))
    gb = rng.integers(0, 100, (n_gt, 2))
    gb = np.concatenate([gb, gb + rng.integers(3, 60, (n_gt, 2))], 1).astype(np.float32)
    src = rng.integers(0, n_gt, n_det)
    db = (gb[src] + rng.integers(-5, 6, (n_det, 4))).astype(np.float32)
    db[:, 2:] = np.maximum(db[:, 2:], db[:, :2] + 1)
    return ({"boxes": db.tolist(), "scores": (rng.integers(0, 16, n_det) / 16).tolist(),
             "labels": rng.integers(0, 3, n_det).tolist()},
            {"boxes": gb.tolist(), "labels": rng.integers(0, 3, n_gt).tolist(),
             "iscrowd": (rng.random(n_gt) < 0.1).tolist()})


def _batch(seed, n_images, n_rows):
    rng = np.random.default_rng(seed)
    images = [_image(rng) for _ in range(n_images)]
    centres = rng.normal(scale=3.0, size=(4, 3))
    labels = rng.integers(0, 4, n_rows)
    data = centres[labels] + rng.normal(size=(n_rows, 3))
    target = rng.integers(0, 4, n_rows)
    preds = np.where(rng.random(n_rows) < 0.6, target, rng.integers(0, 5, n_rows))
    return {"images": {"preds": [p for p, _ in images], "target": [t for _, t in images]} if images else None,
            "data": data.tolist(), "labels": labels.tolist(), "preds": preds.tolist(), "target": target.tolist()}


# rank 0: three batches with many images, rank 1: one image and a few rows, rank 2: no update at all
_PLAN = [[(6, 40), (4, 23), (5, 31)], [(1, 9)], []]


def test_three_rank_gloo_leaf_sync_equals_one_process(tmp_path):
    epoch = [[_batch(10 * r + i, *size) for i, size in enumerate(sizes)] for r, sizes in enumerate(_PLAN)]
    data = tmp_path / "batches.json"
    data.write_text(json.dumps(epoch))
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

    namespace = {}
    exec(_COMMON, namespace)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        one = namespace["collections"]()
        for batch in (b for rank in epoch for b in rank):
            namespace["feed"](one, batch)
        plain, flat = namespace["plain"], namespace["flat"]
        want = {name: flat({k: plain(v) for k, v in col.compute().items()}) for name, col in one.items()}
    counts = one["cont"]["rand"].contingency.tolist()

    for r, res in enumerate(results):
        for name in ("map", "map_cap", "db", "db_cap", "cont"):
            got, expect = res["values"][name], want[name]
            assert sorted(got) == sorted(expect)
            for k in expect:
                np.testing.assert_array_equal(np.asarray(got[k], dtype=np.float64),
                                              np.asarray(expect[k], dtype=np.float64), err_msg=f"rank {r} {name}.{k}")
        np.testing.assert_allclose(res["values"]["ch"]["ch"], want["ch"]["ch"], rtol=1e-6)
        assert sorted(res["values"]["map"]) == sorted(want["map"]) and len(want["map"]) == 14
        assert res["contingency"] == counts, f"rank {r}"
        # the gather plane for the sample states, the sum bucket for the contingency family
        assert res["calls"]["map"] == ["all_gather"] and res["calls"]["db"] == ["all_gather"]
        assert res["calls"]["ch"] == ["all_gather"]
        assert res["calls"]["cont"] == ["all_reduce"]
    assert np.isfinite(want["map"]["map.map"]) and want["map"]["map.map"] > 0
