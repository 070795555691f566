"""Retrieval synced across three real processes (Gloo), against one process over all rows.

Three ranks over ``torch.distributed`` (Gloo, a FileStore under ``tmp_path``):
rank 0 holds two batches, rank 1 one, rank 2 none, and the rows of one query sit
on ranks 0 and 1. Each rank runs the eight retrieval metrics in one
``MetricCollection``, once with list states and once with ``capacity``
(PaddedBuffer states). The epoch ``compute()`` gathers the group's three
states once: one layout ``all_gather`` and one per dtype (int32 ids and
targets, float32 scores), and no ``all_reduce``. Every rank's value of every
member equals one process over all rows in rank order (ties break by that
order), to rtol 1e-6: the same float32 formulas over the same rows.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import torch

import metrics_tpu_torch as pt

torch.set_num_threads(1)

_REPO = Path(__file__).resolve().parents[1]

_WORKER = textwrap.dedent("""
    import json, sys, warnings
    import torch, torch.distributed as dist
    sys.path.insert(0, {repo!r})
    import metrics_tpu_torch as pt
    sys.path.insert(0, {tests!r})
    from test_torch_sync_retrieval import collection

    warnings.simplefilter("ignore")
    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=3)
    batches = json.load(open({data!r}))[rank]

    calls = []
    real_gather, real_reduce = dist.all_gather, dist.all_reduce
    dist.all_gather = lambda *a, **k: (calls.append("all_gather"), real_gather(*a, **k))[1]
    dist.all_reduce = lambda *a, **k: (calls.append("all_reduce"), real_reduce(*a, **k))[1]

    result = {{}}
    for mode, capacity in (("list", None), ("capacity", 64)):
        col = collection(capacity)
        for idx, preds, target in batches:
            col.update(torch.tensor(idx), torch.tensor(preds), torch.tensor(target))
        del calls[:]
        values = col.compute()
        result[mode] = {{"values": {{k: float(v) for k, v in values.items()}}, "calls": list(calls),
                        "groups": len(col.compute_groups),
                        "local_rows": sum(len(b[0]) for b in batches)}}
    json.dump(result, open(out, "w"))
    dist.destroy_process_group()
""")


def collection(capacity=None):
    kw = {"device": "cpu", "capacity": capacity}
    return pt.MetricCollection([
        pt.RetrievalMAP(**kw), pt.RetrievalMRR(query_without_relevant_docs="neg", **kw),
        pt.RetrievalPrecision(k=2, **kw), pt.RetrievalRecall(k=3, **kw), pt.RetrievalHitRate(k=1, **kw),
        pt.RetrievalFallOut(k=2, **kw), pt.RetrievalRPrecision(**kw), pt.RetrievalNormalizedDCG(k=3, **kw),
    ])


def _batch(seed, queries, rows):
    rng = np.random.RandomState(seed)
    idx = rng.choice(queries, rows)
    preds = np.round(rng.rand(rows) * 4) / 4  # tied
    target = np.where(rng.rand(rows) < 0.4, rng.randint(1, 4, rows), 0)
    target[rng.rand(rows) < 0.1] = -100
    return [idx.tolist(), preds.astype(np.float32).tolist(), target.tolist()]


# query 7 has rows on ranks 0 and 1; rank 2 holds no rows
_BATCHES = [[_batch(1, [3, 7, 11], 14), _batch(2, [5, 7], 9)], [_batch(3, [7, 19, 23], 12)], []]


def test_three_rank_gloo_retrieval_sync_equals_one_process(tmp_path):
    data = tmp_path / "batches.json"
    data.write_text(json.dumps(_BATCHES))
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=str(_REPO), tests=str(_REPO / "tests"), data=str(data)))
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

    one = collection()
    for idx, preds, target in (b for rank in _BATCHES for b in rank):
        one.update(torch.tensor(idx), torch.tensor(preds), torch.tensor(target))
    want = {k: float(v) for k, v in one.compute().items()}
    assert len(want) == 8 and len(set(want.values())) > 3

    for r, res in enumerate(results):
        for mode in ("list", "capacity"):
            got = res[mode]
            np.testing.assert_allclose([got["values"][k] for k in want], list(want.values()), rtol=1e-6, atol=0)
            assert got["groups"] == 1
            assert got["calls"] == ["all_gather"] * 3  # one gather for the group: layout, int32, float32
            assert got["local_rows"] == sum(len(b[0]) for b in _BATCHES[r])
