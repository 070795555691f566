"""The keyed wrappers and the pure view synced across three real processes (Gloo).

Three ranks over ``torch.distributed`` (Gloo, a FileStore under ``tmp_path``),
uneven batch sizes, one rank with no update at all:

* ``Keyed(AUROC(approx="sketch"))`` and ``Keyed(Accuracy())`` at K = 64 and
  K = 4,096: the synced slabs equal one process over every rank's rows bit for
  bit, the values equal its values, and a ``compute()`` makes one
  ``all_reduce`` per state dtype whatever K is: the unkeyed metric's count.
  With ``dist_sync_on_step`` every step makes one ``all_reduce`` per dtype
  and its value is the one process's over that step's rows of every rank;
* ``HeavyHitters(MeanSquaredError())``: two ``all_reduce`` calls (its states
  are float32 and int64 sums: two buckets, as the unkeyed metric's), and the
  synced hot rows plus tail mass count every rank's samples;
* ``pure().sync(state, group)`` reduces a state dict over the group and leaves
  the metric's own state as it is;
* ``BootStrapper`` takes its per-copy loop when the world size is above 1, and
  every rank computes the same synced statistics.

Tolerances: counts are integers and equal; values from equal counts by the
same math are equal; float sums (MeanSquaredError's squared errors) agree to
rtol 1e-6 (another summation order).
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

BINS = 16


def metrics(k):
    cpu = dict(device="cpu")
    return {
        "auroc": pt.Keyed(pt.AUROC(approx="sketch", num_bins=BINS, **cpu), num_slots=k),
        "accuracy": pt.Keyed(pt.Accuracy(**cpu), num_slots=k),
    }


def feed(ms, batch):
    scores, labels, slots = (torch.tensor(x) for x in batch[:3])
    ms["auroc"].update(scores, labels, slot=slots)
    ms["accuracy"].update(scores, labels, slot=slots)


def plain(v):
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

    result = {{"values": {{}}, "calls": {{}}, "synced": {{}}, "steps": []}}
    for k in (64, 4096):
        ms = metrics(k)
        for batch in data["epoch"][rank]:
            feed(ms, batch)
        for name, m in ms.items():
            del calls[:]
            result["values"][f"{{name}}@{{k}}"] = plain(m.compute())
            result["calls"][f"{{name}}@{{k}}"] = list(calls)
            result["synced"][f"{{name}}@{{k}}"] = {{n: (v.counts if hasattr(v, "counts") else v).tolist()
                                                   for n, v in m._synced_state().items()}}
    unkeyed = {{"auroc": pt.AUROC(approx="sketch", num_bins=BINS, device="cpu"), "accuracy": pt.Accuracy(device="cpu")}}
    for name, m in unkeyed.items():
        for batch in data["epoch"][rank]:
            m.update(torch.tensor(batch[0]), torch.tensor(batch[1]))
        del calls[:]
        m.compute()
        result["calls"][name] = list(calls)

    stepper = pt.Keyed(pt.AUROC(approx="sketch", num_bins=BINS, device="cpu"), num_slots=64, dist_sync_on_step=True)
    for scores, labels, slots in data["steps"][rank]:
        del calls[:]
        value = stepper(torch.tensor(scores, dtype=torch.float32), torch.tensor(labels), slot=torch.tensor(slots))
        result["steps"].append({{"values": plain(value), "calls": list(calls)}})

    hh = pt.HeavyHitters(pt.MeanSquaredError(device="cpu"), num_hot_slots=4, tail=(4, 32))
    for batch in data["epoch"][rank]:
        hh.update(torch.tensor(batch[3]), torch.tensor(batch[4]), key=batch[2])
    del calls[:]
    synced = hh._synced_state()
    result["hh"] = {{"calls": list(calls), "rows": int(synced["hh_rows"].sum()),
                     "tail": int(synced["hh_tail_rows"].counts[0].sum()),
                     "sse": float(synced["sum_squared_error"].sum() + synced["sum_squared_error_tail"].counts[0].sum())}}

    metric = pt.AUROC(approx="sketch", num_bins=BINS, device="cpu")
    pure = metric.pure()
    state = pure.init()
    for batch in data["epoch"][rank]:
        state = pure.update(state, torch.tensor(batch[0]), torch.tensor(batch[1]))
    del calls[:]
    synced = pure.sync(state, dist.group.WORLD)
    result["pure"] = {{"counts": synced["hist"].counts.tolist(), "value": float(pure.compute(synced)),
                       "calls": list(calls), "own": int(metric.hist.counts.sum())}}

    boot = pt.BootStrapper(pt.MeanSquaredError(device="cpu"), num_bootstraps=4, seed=1)
    for batch in data["epoch"][rank]:
        boot.update(torch.tensor(batch[3]), torch.tensor(batch[4]))
    stats = {{k: plain(v) for k, v in boot.compute().items()}}
    result["boot"] = {{"mode": boot._mode, "stats": stats}}
    json.dump(result, open(out, "w"))
    dist.destroy_process_group()
""")

# rank 0: three batches, rank 1: one, rank 2: no update at all
_SIZES = [[90, 41, 13], [57], []]
# dist_sync_on_step: every rank steps together; a 0 is an empty batch on that rank
_STEP_SIZES = [[30, 11, 0], [16, 0, 9], [0, 5, 21]]


def _batch(seed, n):
    rng = np.random.RandomState(seed)
    labels = (rng.rand(n) < 0.4).astype(np.int64)
    scores = (1 / (1 + np.exp(-(rng.randn(n) + labels)))).astype(np.float32)
    slots = rng.randint(-1, 65, n)
    target = np.exp(rng.randn(n)).astype(np.float32)
    preds = (target * np.exp(0.2 * rng.randn(n))).astype(np.float32)
    return [scores.tolist(), labels.tolist(), slots.tolist(), preds.tolist(), target.tolist()]


def test_three_rank_gloo_keyed_sync_equals_one_process(tmp_path):
    epoch = [[_batch(10 * r + i, n) for i, n in enumerate(sizes)] for r, sizes in enumerate(_SIZES)]
    steps = [[_batch(100 + 10 * r + i, n)[:3] for i, n in enumerate(sizes)] for r, sizes in enumerate(_STEP_SIZES)]
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
        logs = [p.communicate(timeout=240)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0, 0], logs
    results = [json.loads((tmp_path / f"out{r}.json").read_text()) for r in range(3)]

    namespace = {"torch": torch}
    exec(_COMMON, namespace)
    everything = [b for rank in epoch for b in rank]
    want, want_state = {}, {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for k in (64, 4096):
            one = namespace["metrics"](k)
            for batch in everything:
                namespace["feed"](one, batch)
            for name, m in one.items():
                want[f"{name}@{k}"] = m.compute().tolist()
                want_state[f"{name}@{k}"] = {n: (v.counts if hasattr(v, "counts") else v).tolist()
                                             for n, v in m._current_state().items()}
    total = sum(len(b[0]) for b in everything)
    sse = sum(float(np.sum((np.float32(b[3]).astype(np.float64) - np.float32(b[4])) ** 2)) for b in everything)
    unkeyed = pt.AUROC(approx="sketch", num_bins=16, device="cpu")
    for batch in everything:
        unkeyed.update(torch.tensor(batch[0]), torch.tensor(batch[1]))

    for r, res in enumerate(results):
        assert sorted(res["values"]) == sorted(want)
        for key, value in want.items():  # empty slots are NaN on both sides
            assert np.array_equal(np.asarray(res["values"][key]), np.asarray(value), equal_nan=True), (r, key)
        assert res["synced"] == want_state, f"rank {r}"
        # one all_reduce per state dtype whatever K is: the unkeyed metric's count
        assert res["calls"]["auroc@64"] == res["calls"]["auroc@4096"] == res["calls"]["auroc"] == ["all_reduce"]
        assert res["calls"]["accuracy@64"] == res["calls"]["accuracy@4096"] == res["calls"]["accuracy"] \
            == ["all_reduce"]
        for step in range(3):
            rows = [steps[q][step] for q in range(3)]
            ref = pt.Keyed(pt.AUROC(approx="sketch", num_bins=16, device="cpu"), num_slots=64)
            ref.update(torch.tensor(np.concatenate([np.float32(x[0]) for x in rows])),
                       torch.tensor(np.concatenate([np.int64(x[1]) for x in rows])),
                       slot=torch.tensor(np.concatenate([np.int64(x[2]) for x in rows])))
            got = np.asarray(res["steps"][step]["values"], dtype=np.float64)
            np.testing.assert_array_equal(got, ref.compute().numpy().astype(np.float64))
            assert res["steps"][step]["calls"] == ["all_reduce"]
        hh = res["hh"]
        assert hh["calls"] == ["all_reduce", "all_reduce"]  # float32 and int64 sums, as MeanSquaredError's
        assert hh["rows"] + hh["tail"] == total
        # every sample sits in one tier: the hot rows plus the tail's row 0 hold all the squared error
        np.testing.assert_allclose(hh["sse"], sse, rtol=1e-6)
        pure = res["pure"]
        assert pure["calls"] == ["all_reduce"] and pure["own"] == 0
        assert pure["counts"] == unkeyed.hist.counts.tolist() and pure["value"] == float(unkeyed.compute())
        assert res["boot"]["mode"] == "loop"
        assert res["boot"]["stats"] == results[0]["boot"]["stats"]
