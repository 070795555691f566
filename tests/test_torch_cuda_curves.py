"""The exact curve family and the cat-state gather on the card, held against the CPU.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is false.
This file imports no JAX, so it runs on a GPU machine without the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_curves.py

* The static-shape kernels of ``curve_static`` at N = 1,048,576 with ties,
  NaN scores and ghost rows: thresholds and valid counts equal the CPU run
  exactly, unit-weight curve points too (float32 counts of 0/1 are exact below
  2**24); AUROC / AP and weighted curves agree to rtol 1e-5 (sums in another
  order).
* A one-rank NCCL group: the list and PaddedBuffer gathers return the local
  rows (a buffer compacted, capacity 1 x capacity) in three ``all_gather``
  calls, and the synced AUROC equals the local one.
* On a machine with two or more cards (skips on one): one NCCL process per
  card, uneven batch counts and sizes, the last rank with no update at all.
  The gathered list, stack and PaddedBuffer states equal the rank-major
  concatenation on every rank, and the synced AUROC / AP equal one process
  over all rows.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from metrics_tpu_torch.functional.classification import curve_static

N = 1_048_576
RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _inputs(seed, n=N):
    rng = np.random.RandomState(seed)
    p = (rng.randint(0, 50_000, n) / 50_000).astype(np.float32)  # many ties
    p[rng.choice(n, 64, replace=False)] = np.nan
    return p, (rng.rand(n) < 0.1).astype(np.int64), rng.rand(n).astype(np.float32)


def _assert_equal_or_close(card, cpu, rtol):
    for c, h in zip(card, cpu):
        c = c.cpu()
        if h.dtype.is_floating_point and rtol:
            torch.testing.assert_close(c, h, rtol=rtol, atol=1e-7, equal_nan=True)
        else:
            assert torch.equal(c.nan_to_num(-7.0), h.nan_to_num(-7.0))


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True])
def test_static_scores_match_cpu(cuda, weighted):
    p, y, w = (torch.from_numpy(x) for x in _inputs(1))
    w = w if weighted else None
    for fn in (curve_static.binary_auroc_static, curve_static.binary_average_precision_static):
        card = fn(p.to(cuda), y.to(cuda), None if w is None else w.to(cuda))
        cpu = fn(p, y, w)
        torch.testing.assert_close(card.cpu(), cpu, rtol=RTOL, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["roc_padded", "precision_recall_curve_padded"])
@pytest.mark.parametrize("weighted", [False, True])
def test_padded_curves_match_cpu(cuda, kernel, weighted):
    p, y, w = (torch.from_numpy(x) for x in _inputs(2))
    mask = torch.arange(N) < N - 1000  # ghost rows at the tail
    w = w if weighted else None
    fn = getattr(curve_static, kernel)
    card = fn(p.to(cuda), y.to(cuda), None if w is None else w.to(cuda), 1, mask.to(cuda))
    cpu = fn(p, y, w, 1, mask)
    assert int(card[3]) == int(cpu[3])  # valid count
    _assert_equal_or_close(card, cpu, RTOL if weighted else 0)


@pytest.mark.cuda
def test_blocked_reverse_cummin_matches_one_scan(cuda):
    x = torch.rand(3, N // 4 + 17, device=cuda)
    want = torch.flip(torch.cummin(torch.flip(x, [-1]), -1).values, [-1])
    assert torch.equal(curve_static._reverse_cummin(x), want)


@pytest.mark.cuda
def test_padded_buffer_gather_one_rank_nccl(cuda):
    import torch.distributed as dist

    import metrics_tpu_torch as pt
    from metrics_tpu_torch.functional import auroc
    from metrics_tpu_torch.parallel.buffer import PaddedBuffer

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    calls = []
    real = dist.all_gather
    dist.all_gather = lambda *a, **k: (calls.append(1), real(*a, **k))[1]
    try:
        p, y, _ = (torch.from_numpy(x) for x in _inputs(3, n=200_000))
        p = p.nan_to_num(0.5)  # equal rows compare equal
        buf, lst = pt.AUROC(pos_label=1, capacity=300_000, device=cuda), pt.AUROC(pos_label=1, device=cuda)
        for m in (buf, lst):
            m.update(p[:120_000].to(cuda), y[:120_000].to(cuda))
            m.update(p[120_000:].to(cuda), y[120_000:].to(cuda))
        synced = buf._synced_state()
        assert len(calls) == 3  # layout table, float32, int64
        assert isinstance(synced["preds"], PaddedBuffer) and synced["preds"].capacity == 300_000
        assert int(synced["preds"].count) == 200_000
        assert torch.equal(synced["preds"].data[:200_000].cpu(), p)
        assert torch.equal(synced["target"].data[:200_000].cpu(), y)
        assert not synced["preds"].data[200_000:].any()
        listed = lst._synced_state()
        assert torch.equal(torch.cat(listed["preds"]).cpu(), p)
        local = auroc(p, y, pos_label=1)
        torch.testing.assert_close(buf.compute().cpu(), local, rtol=RTOL, atol=0)
        torch.testing.assert_close(lst.compute().cpu(), local, rtol=RTOL, atol=0)
    finally:
        dist.all_gather = real
        dist.destroy_process_group()


_WORKER = textwrap.dedent("""
    import json, sys, warnings
    import numpy as np, torch, torch.distributed as dist
    sys.path.insert(0, {repo!r})
    import metrics_tpu_torch as pt
    from metrics_tpu_torch.parallel.buffer import PaddedBuffer

    warnings.simplefilter("ignore")
    rank, world, backend, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4], sys.argv[5]
    device = torch.device("cuda", rank) if backend == "nccl" else torch.device("cpu")
    if backend == "nccl":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method="tcp://127.0.0.1:" + port, rank=rank, world_size=world)

    class Last(pt.Metric):
        def __init__(self):
            super().__init__(device=device)
            self.add_state("last", torch.zeros(2), dist_reduce_fx=None)

        def update(self, preds, target):
            self.last = torch.stack([preds.sum(), target.sum().to(torch.float32)])

        def compute(self):
            return self.last

    metrics = {{"auroc": pt.AUROC(pos_label=1, device=device),
               "ap_cap": pt.AveragePrecision(pos_label=1, num_classes=1, capacity=4096, device=device),
               "samples": pt.StatScores(reduce="samples", device=device), "last": Last()}}
    rng = np.random.RandomState(rank)
    sizes = [] if rank == world - 1 else [97 * (rank + 1) + 5 * i for i in range(rank + 1)]
    for n in sizes:
        p = torch.from_numpy((rng.randint(0, 50, n) / 50).astype(np.float32)).to(device)
        y = torch.from_numpy(rng.randint(0, 2, n)).to(device)
        for m in metrics.values():
            m.update(p, y)

    def plain(v):
        if isinstance(v, PaddedBuffer):
            return {{"data": v.data[: int(v.count)].tolist(), "count": int(v.count), "capacity": v.capacity}}
        if isinstance(v, list):
            return [x.tolist() for x in v]
        return v.tolist()

    result = {{"states": {{n: {{k: plain(v) for k, v in m._synced_state().items()}} for n, m in metrics.items()}},
              "values": {{n: m.compute().tolist() for n, m in metrics.items()}}}}
    json.dump(result, open(out, "w"))
    dist.destroy_process_group()
""")


def run_gather_world(world, backend, tmp_path, repo):
    """Spawn ``world`` ranks of the worker above; returns each rank's synced states and values."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = Path(tmp_path) / "gather_worker.py"
    script.write_text(_WORKER.format(repo=str(repo)))
    outs = [Path(tmp_path) / f"gather{r}.json" for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(world), backend, str(port), str(outs[r])],
                              env=dict(os.environ, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * world, logs
    return [json.loads(o.read_text()) for o in outs]


def check_gather_world(results):
    """Every rank holds the rank-major concatenation; values equal one process over all rows."""
    import metrics_tpu_torch as pt

    world = len(results)
    preds, target = [], []
    for rank in range(world):
        rng = np.random.RandomState(rank)
        for n in ([] if rank == world - 1 else [97 * (rank + 1) + 5 * i for i in range(rank + 1)]):
            preds.append((rng.randint(0, 50, n) / 50).astype(np.float32))
            target.append(rng.randint(0, 2, n))
    p, y = np.concatenate(preds), np.concatenate(target)
    one = pt.AUROC(pos_label=1, device="cpu")
    one.update(torch.from_numpy(p), torch.from_numpy(y))
    want_auroc = one.compute().item()
    for res in results:
        st = res["states"]
        assert len(st["auroc"]["preds"]) == world and st["auroc"]["preds"][-1] == []
        np.testing.assert_array_equal(np.concatenate([np.asarray(x, np.float32) for x in st["auroc"]["preds"]]), p)
        buf = st["ap_cap"]["target"]
        assert buf["count"] == len(y) and buf["capacity"] == world * 4096
        np.testing.assert_array_equal(np.asarray(buf["data"]), y)
        assert len(st["last"]["last"]) == world and st["last"]["last"][-1] == [0.0, 0.0]
        assert sum(len(part) for part in st["samples"]["tp"]) == len(y)
        np.testing.assert_allclose(res["values"]["auroc"], want_auroc, rtol=RTOL)


@pytest.mark.cuda
def test_uneven_gather_across_cards_nccl(cuda, tmp_path):
    world = torch.cuda.device_count()
    if world < 2:
        pytest.skip("needs two or more cards")
    check_gather_world(run_gather_world(world, "nccl", tmp_path, Path(__file__).resolve().parents[1]))
