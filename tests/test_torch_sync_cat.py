"""Cross-rank sync of cat, stack and PaddedBuffer states, and the grouped epoch sync.

* Through a fake ``dist_sync_fn`` world, against the JAX package: the
  PaddedBuffer arm of ``host_gather``, and ``MetricCollection.compute()``
  gathering once per compute group (the gather-call counts of
  ``tests/bases/test_grouped_host_sync.py``, and the same values).
* Three real processes over ``torch.distributed`` (Gloo, a FileStore under
  ``tmp_path``) with uneven batch counts and sizes, one rank with no update at
  all: the synced list (cat), stack (``None``) and PaddedBuffer states equal
  the one-process states over the rank-major concatenation, the metric values
  equal the one-process values, and the collectives are counted: one layout
  ``all_gather`` plus one ``all_gather`` per dtype for a metric's gather
  states, one ``all_reduce`` per compute group at the epoch.
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
import pytest
import torch

import metrics_tpu as mt
import metrics_tpu_torch as pt
from metrics_tpu.parallel.buffer import buffer_append as jax_append, buffer_init as jax_init
from metrics_tpu.parallel.sync import host_gather as jax_host_gather
from metrics_tpu_torch.parallel.buffer import buffer_append, buffer_init
from metrics_tpu_torch.parallel.sync import host_gather

torch.set_num_threads(1)

_REPO = Path(__file__).resolve().parents[1]
C = 4


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


class _CountingGather:
    """fn(x) -> [x, x] (or [x, 0 * x]): a fake two-rank world, counting its calls."""

    def __init__(self, same=True):
        self.calls = 0
        self.same = same

    def __call__(self, x):
        self.calls += 1
        return [x, x] if self.same else [x, x * 0]


def _main(pkg, gather, compute_groups=True):
    extra = {"device": "cpu"} if pkg is pt else {}
    return pkg.MetricCollection(
        [
            pkg.Accuracy(dist_sync_fn=gather, **extra),
            pkg.F1(num_classes=C, average="macro", dist_sync_fn=gather, **extra),
            pkg.Precision(num_classes=C, average="macro", dist_sync_fn=gather, **extra),
            pkg.Recall(num_classes=C, average="macro", dist_sync_fn=gather, **extra),
        ],
        compute_groups=compute_groups,
    )


def _batch(seed, n=32):
    rng = np.random.RandomState(seed)
    logits = rng.rand(n, C).astype(np.float32)
    return logits / logits.sum(-1, keepdims=True), rng.randint(0, C, n)


def _values(out):
    return {k: float(np.asarray(v)) for k, v in out.items()}


@pytest.mark.parametrize("scenario,port_calls", [("shared", 6), ("diverged", 10), ("ungrouped", 14), ("reset", 6)])
def test_grouped_epoch_sync_gathers_once_per_group_like_jax(scenario, port_calls):
    """Accuracy (2 states) alone + ONE gather plane (4 states) for F1 / Precision / Recall."""
    grouped = scenario != "ungrouped"
    counts, values = [], []
    for pkg, conv in ((pt, torch.from_numpy), (mt, jnp.asarray)):
        gather = _CountingGather()
        col = _main(pkg, gather, compute_groups=grouped)
        p, y = _batch(1)
        col(conv(p), conv(y))
        if scenario in ("diverged", "reset"):
            col["Recall"].update(*(conv(x) for x in _batch(2)))  # written outside the collection
        if scenario == "reset":
            col.compute()
            col.reset()
            col(conv(p), conv(y))
            gather.calls = 0
        values.append(_values(col.compute()))
        counts.append(gather.calls)
        first = gather.calls
        col.compute()  # member caches: no further gathers
        assert gather.calls == first
    assert counts == [port_calls, port_calls]
    assert values[0].keys() == values[1].keys()
    for k in values[0]:
        np.testing.assert_allclose(values[0][k], values[1][k], rtol=1e-6, err_msg=k)


def test_grouped_epoch_sync_keeps_each_members_local_state():
    gather = _CountingGather()
    col = _main(pt, gather)
    p, y = _batch(3)
    col(torch.from_numpy(p), torch.from_numpy(y))
    tp_before = col["Precision"].tp
    col.compute()
    assert col["Precision"].tp is tp_before  # the local state is back, not the synced one
    p2, y2 = _batch(4)
    col(torch.from_numpy(p2), torch.from_numpy(y2))
    twice = _main(pt, _CountingGather())
    twice(torch.from_numpy(p), torch.from_numpy(y))
    twice(torch.from_numpy(p2), torch.from_numpy(y2))
    assert _values(col.compute()) == _values(twice.compute())


@pytest.mark.parametrize("same,rows_out", [(True, 12), (False, 6)])
def test_host_gather_buffer_arm_matches_jax(same, rows_out):
    """The other fake rank holds the same buffer (12 rows out) or an empty one (count 0: 6 rows out)."""
    rng = np.random.RandomState(5)
    rows = rng.rand(6, 2).astype(np.float32)
    port = {"b": buffer_append(buffer_init(8, (2,)), torch.from_numpy(rows)), "l": [torch.arange(3)]}
    ref = {"b": jax_append(jax_init(8, (2,)), jnp.asarray(rows)), "l": [jnp.arange(3)]}
    fx = {"b": None, "l": "cat"}
    got = host_gather(port, fx, _CountingGather(same))
    want = jax_host_gather(ref, fx, gather_fn=_CountingGather(same))
    for k in fx:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    assert got["b"].shape == (rows_out, 2)


_WORKER = textwrap.dedent("""
    import json, sys, warnings
    import numpy as np, torch, torch.distributed as dist
    sys.path.insert(0, {repo!r})
    import metrics_tpu_torch as pt
    from metrics_tpu_torch.parallel.buffer import PaddedBuffer

    warnings.simplefilter("ignore")
    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=3)
    data = json.load(open({data!r}))

    calls = []
    real_gather, real_reduce = dist.all_gather, dist.all_reduce
    dist.all_gather = lambda *a, **k: (calls.append("all_gather"), real_gather(*a, **k))[1]
    dist.all_reduce = lambda *a, **k: (calls.append("all_reduce"), real_reduce(*a, **k))[1]

    class Last(pt.Metric):
        # a stack state (dist_reduce_fx=None on a tensor) and a float64 cat state
        def __init__(self):
            super().__init__(device="cpu")
            self.add_state("last", torch.zeros(2), dist_reduce_fx=None)
            self.add_state("seen", [], dist_reduce_fx="cat", item_shape=(), item_dtype=torch.float64)

        def update(self, preds, target):
            self.last = torch.stack([preds.sum(), target.sum().to(torch.float32)])
            self._append("seen", preds.to(torch.float64))

        def compute(self):
            return self.last

    metrics = {{
        "auroc": pt.AUROC(pos_label=1, device="cpu"),
        "auroc_cap": pt.AUROC(pos_label=1, capacity=64, device="cpu"),
        "ap_cap": pt.AveragePrecision(pos_label=1, num_classes=1, capacity=64, device="cpu"),
        "samples": pt.StatScores(reduce="samples", device="cpu"),
        "last": Last(),
    }}
    main = {{
        groups: pt.MetricCollection([
            pt.Accuracy(device="cpu"),
            pt.F1(num_classes={c}, average="macro", device="cpu"),
            pt.Precision(num_classes={c}, average="macro", device="cpu"),
            pt.Recall(num_classes={c}, average="macro", device="cpu"),
        ], compute_groups=groups)
        for groups in (True, False)
    }}
    for batch in data["curve"][rank]:
        p, y = torch.tensor(batch[0], dtype=torch.float32), torch.tensor(batch[1])
        for m in metrics.values():
            m.update(p, y)
    for batch in data["main"][rank]:
        for col in main.values():
            col.update(torch.tensor(batch[0], dtype=torch.float32), torch.tensor(batch[1]))

    def plain(v):
        if isinstance(v, PaddedBuffer):
            return {{"data": v.data.tolist(), "count": int(v.count), "capacity": v.capacity}}
        if isinstance(v, list):
            return [x.tolist() for x in v]
        return v.tolist()

    result = {{"states": {{}}, "values": {{}}, "calls": {{}}}}
    for name, m in metrics.items():
        del calls[:]
        result["states"][name] = {{k: plain(v) for k, v in m._synced_state().items()}}
        result["calls"][name] = list(calls)
        value = m.compute()
        result["values"][name] = value.tolist()
    for groups, col in main.items():
        del calls[:]
        result["values"]["main_" + str(groups)] = {{k: v.item() for k, v in col.compute().items()}}
        result["calls"]["main_" + str(groups)] = list(calls)
    result["local_kept"] = isinstance(metrics["auroc"].preds, list) and len(metrics["auroc"].preds) == len(data["curve"][rank])
    json.dump(result, open(out, "w"))
    dist.destroy_process_group()
""")

# rank 0: three batches, rank 1: one, rank 2: no update at all
_CURVE_SIZES = [[5, 7, 3], [11], []]
_MAIN_SIZES = [[16, 8], [], [12]]


def _curve_batch(seed, n):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, 10, n) / 10).astype(np.float32), rng.randint(0, 2, n)


def test_three_rank_gloo_gather_equals_one_process(tmp_path):
    curve = [[_curve_batch(10 * r + i, n) for i, n in enumerate(sizes)] for r, sizes in enumerate(_CURVE_SIZES)]
    main = [[_batch(100 + 10 * r + i, n) for i, n in enumerate(sizes)] for r, sizes in enumerate(_MAIN_SIZES)]
    data = tmp_path / "batches.json"
    data.write_text(json.dumps({
        "curve": [[[p.tolist(), y.tolist()] for p, y in rank] for rank in curve],
        "main": [[[p.tolist(), y.tolist()] for p, y in rank] for rank in main],
    }))
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.format(repo=str(_REPO), data=str(data), c=C))
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [
        subprocess.Popen([sys.executable, str(script), str(r), str(tmp_path / "store"), str(tmp_path / f"out{r}.json")],
                         env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(3)
    ]
    try:
        logs = [p.communicate(timeout=180)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0, 0], logs
    results = [json.loads((tmp_path / f"out{r}.json").read_text()) for r in range(3)]

    # the one-process run over the rank-major concatenation
    flat = [b for rank in curve for b in rank]
    all_p = np.concatenate([p for p, _ in flat])
    all_y = np.concatenate([y for _, y in flat])
    one = {
        "auroc": pt.AUROC(pos_label=1, device="cpu"),
        "ap_cap": pt.AveragePrecision(pos_label=1, num_classes=1, capacity=64, device="cpu"),
        "samples": pt.StatScores(reduce="samples", device="cpu"),
    }
    for p, y in flat:
        for m in one.values():
            m.update(torch.from_numpy(p), torch.from_numpy(y))
    n = len(all_p)
    for r, res in enumerate(results):
        st = res["states"]
        # cat (list) state: per-rank parts in rank order, the empty rank's part empty
        assert [len(part) for part in st["auroc"]["preds"]] == [15, 11, 0]
        np.testing.assert_array_equal(np.concatenate([np.asarray(x, np.float32) for x in st["auroc"]["preds"]]), all_p)
        np.testing.assert_array_equal(np.concatenate([np.asarray(x, np.int64) for x in st["auroc"]["target"]]), all_y)
        # PaddedBuffer: compacted to the front in rank order, capacity world * 64
        buf = st["auroc_cap"]["preds"]
        assert buf["count"] == n and buf["capacity"] == 3 * 64
        np.testing.assert_array_equal(np.asarray(buf["data"][:n], np.float32), all_p)
        assert not any(buf["data"][n:])
        # stack state: (world, 2), the empty rank's row its default
        want_last = [[float(curve[q][-1][0].sum()), float(curve[q][-1][1].sum())] if curve[q] else [0.0, 0.0]
                     for q in range(3)]
        np.testing.assert_allclose(st["last"]["last"], want_last, rtol=1e-6)
        # "cat" state declared with a float64 layout: one tensor
        np.testing.assert_allclose(st["last"]["seen"], all_p.astype(np.float64))
        # StatScores samples: the empty rank learned the int64 (N,) layout from the table
        for s in ("tp", "fp", "tn", "fn"):
            got = np.concatenate([np.asarray(x, np.int64) for x in st["samples"][s]])
            np.testing.assert_array_equal(got, torch.cat(getattr(one["samples"], s)).numpy())
        # values
        np.testing.assert_allclose(res["values"]["auroc"], one["auroc"].compute().item(), rtol=1e-6)
        np.testing.assert_allclose(res["values"]["auroc_cap"], one["auroc"].compute().item(), rtol=1e-6)
        np.testing.assert_allclose(res["values"]["ap_cap"], one["ap_cap"].compute().item(), rtol=1e-6)
        np.testing.assert_array_equal(res["values"]["samples"], one["samples"].compute().numpy())
        # collectives: one layout all_gather + one all_gather per dtype, no all_reduce
        assert res["calls"]["auroc"] == ["all_gather"] * 3  # layout, float32, int64
        assert res["calls"]["auroc_cap"] == ["all_gather"] * 3
        assert res["calls"]["samples"] == ["all_gather"] * 2  # layout, int64
        assert res["calls"]["last"] == ["all_gather"] * 3  # layout, float32 (stack), float64 (cat)
        assert res["local_kept"]

    # the main collection: one all_reduce per compute group at the epoch, values unchanged
    one_main = pt.MetricCollection([pt.Accuracy(device="cpu"), pt.F1(num_classes=C, average="macro", device="cpu"),
                                    pt.Precision(num_classes=C, average="macro", device="cpu"),
                                    pt.Recall(num_classes=C, average="macro", device="cpu")])
    for rank in main:
        for p, y in rank:
            one_main.update(torch.from_numpy(p), torch.from_numpy(y))
    want = {k: v.item() for k, v in one_main.compute().items()}
    for res in results:
        assert res["calls"]["main_True"] == ["all_reduce"] * 2
        assert res["calls"]["main_False"] == ["all_reduce"] * 4
        for groups in ("True", "False"):
            for k, v in want.items():
                np.testing.assert_allclose(res["values"]["main_" + groups][k], v, rtol=1e-6, err_msg=k)
