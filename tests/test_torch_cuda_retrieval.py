"""Retrieval on the card, held against the CPU run of the port.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is false.
This file imports no JAX, so it runs on a GPU machine without the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_retrieval.py

* The two-pass sort on the card gives the CPU's row order exactly: NaN scores
  last (after ``-inf``), ties in row order, over 2,000,000 rows on a 2**-6 grid.
* Every grouped segment function on the card equals the CPU run: integer
  results (ranks, counts, hits, first-hit ranks) exactly, float results to
  rtol 1e-6 (float32 divisions and ``log2`` that may round differently, and
  float64 scans over the same rows in another association).
* The eight modules' epoch ``compute()`` under the 'skip' policy makes no
  synchronizing CUDA call (``torch.cuda.set_sync_debug_mode("error")``), and
  under 'error' it makes exactly the one read of its flag.
* On a machine with two or more cards (skips on one): one NCCL process per card,
  each with its own rows, the rows of one query on every rank. Every rank's
  epoch value of each member equals one CPU process over all rows in rank
  order (rtol 1e-6), through one gather for the group (three ``all_gather``).
"""
import os
import socket
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

import metrics_tpu_torch as pt
import metrics_tpu_torch.functional.retrieval as ptr
from metrics_tpu_torch.functional.retrieval.segments import first_relevant_rank

RTOL = 1e-6


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rows(seed, n, queries):
    rng = np.random.default_rng(seed)
    idx = rng.integers(0, queries, n).astype(np.int64)
    preds = (np.round(rng.random(n) * 64) / 64).astype(np.float32)
    preds[rng.random(n) < 0.001] = np.nan
    preds[rng.random(n) < 0.001] = -np.inf
    target = np.where(rng.random(n) < 0.05, rng.integers(1, 4, n), 0).astype(np.int64)
    return idx, preds, target


@pytest.mark.cuda
def test_sort_order_on_the_card_equals_cpu_nan_last_ties_by_row(cuda):
    idx, preds, target = _rows(0, 2_000_000, 5_000)
    rows = torch.arange(len(idx))
    cpu = ptr.sort_by_query_then_score(torch.from_numpy(idx), torch.from_numpy(preds), rows)
    gpu = ptr.sort_by_query_then_score(*(torch.from_numpy(x).to(cuda) for x in (idx, preds)), rows.to(cuda))
    for a, b in zip(cpu, gpu):
        assert torch.equal(a, b.cpu()) if not a.is_floating_point() else torch.equal(a.isnan(), b.cpu().isnan())
    order = cpu[2].numpy()
    expected = np.lexsort((np.arange(len(idx)), np.where(np.isnan(preds), 0, -preds.astype(np.float64)),
                           np.isnan(preds), idx))
    np.testing.assert_array_equal(order, expected)
    d = cpu[0].numpy()
    assert d.tolist() == sorted(d.tolist())


_GROUPED = {
    "ap": lambda d, p, t, n, v: ptr.grouped_average_precision(d, p, t > 0, n),
    "rr": lambda d, p, t, n, v: ptr.grouped_reciprocal_rank(d, p, t, n),
    "first": lambda d, p, t, n, v: first_relevant_rank(d, p, t, n),
    "hits@10": lambda d, p, t, n, v: ptr.grouped_topk_hits(d, p, t, n, 10, v),
    "hit_rate@10": lambda d, p, t, n, v: ptr.grouped_hit_rate(d, p, t, n, 10, v),
    "fall_out@10": lambda d, p, t, n, v: ptr.grouped_fall_out(d, p, t, n, 10, v),
    "r_precision": lambda d, p, t, n, v: ptr.grouped_r_precision(d, p, t, n),
    "ndcg@10": lambda d, p, t, n, v: ptr.grouped_ndcg(d, p, t, n, k=10),
    "ndcg": lambda d, p, t, n, v: ptr.grouped_ndcg(d, p, t, n),
    "positions": lambda d, p, t, n, v: ptr.segment_positions(ptr.sort_by_query_then_score(d, p)[0], n),
    "cumsum": lambda d, p, t, n, v: _relevant_so_far(d, p, t, n),
}


def _relevant_so_far(dense, preds, target, n):
    d, _, t = ptr.sort_by_query_then_score(dense, preds, target)
    return ptr.within_segment_cumsum(t > 0, d, n)


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_GROUPED))
def test_grouped_function_on_the_card_equals_cpu(cuda, name):
    idx, preds, target = _rows(1, 300_000, 3_000)
    dense = np.unique(idx, return_inverse=True)[1].astype(np.int64)
    valid = np.random.default_rng(2).random(len(idx)) > 0.01
    n = len(idx)
    args = [torch.from_numpy(x) for x in (dense, preds, target)]
    want = _GROUPED[name](*args, n, torch.from_numpy(valid))
    got = _GROUPED[name](*(a.to(cuda) for a in args), n, torch.from_numpy(valid).to(cuda))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        if w.is_floating_point():
            torch.testing.assert_close(g.cpu(), w, rtol=RTOL, atol=0)
        else:
            assert torch.equal(g.cpu(), w)


def _collection(device, policy):
    kw = {"device": device, "query_without_relevant_docs": policy}
    return pt.MetricCollection([
        pt.RetrievalMAP(**kw), pt.RetrievalMRR(**kw), pt.RetrievalPrecision(k=10, **kw),
        pt.RetrievalRecall(k=100, **kw), pt.RetrievalHitRate(k=10, **kw), pt.RetrievalFallOut(k=10, **kw),
        pt.RetrievalRPrecision(**kw), pt.RetrievalNormalizedDCG(k=10, **kw),
    ])


@pytest.mark.cuda
def test_skip_policy_compute_makes_no_synchronizing_call(cuda):
    idx, preds, target = _rows(3, 200_000, 2_000)
    target[idx == 0] = 0  # a query with no relevant row: 'error' raises on it
    batch = [torch.from_numpy(x).to(cuda) for x in (idx, preds, target)]
    col = _collection(cuda, "skip")
    col.update(*batch)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        values = col.compute()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    cpu = _collection("cpu", "skip")
    cpu.update(*(torch.from_numpy(x) for x in (idx, preds, target)))
    for k, v in cpu.compute().items():
        torch.testing.assert_close(values[k].cpu(), v, rtol=RTOL, atol=0)

    m = pt.RetrievalMAP(query_without_relevant_docs="error", device=cuda)
    m.update(*batch)
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            with pytest.raises(ValueError, match="without positive targets"):
                m.compute()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert sum("synchroniz" in str(w.message).lower() for w in caught) == 1


_WORKER = textwrap.dedent("""
    import sys, warnings
    import numpy as np, torch, torch.distributed as dist
    sys.path.insert(0, {repo!r})
    sys.path.insert(0, {tests!r})
    from test_torch_cuda_retrieval import _collection, _rank_rows

    warnings.simplefilter("ignore")
    rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:" + port, rank=rank, world_size=world)
    col = _collection(device, "neg")
    col.update(*(torch.from_numpy(x).to(device) for x in _rank_rows(rank)))
    calls = []
    real_gather, real_reduce = dist.all_gather, dist.all_reduce
    dist.all_gather = lambda *a, **k: (calls.append("all_gather"), real_gather(*a, **k))[1]
    dist.all_reduce = lambda *a, **k: (calls.append("all_reduce"), real_reduce(*a, **k))[1]
    values = col.compute()
    torch.save({{"values": {{k: v.cpu() for k, v in values.items()}}, "calls": calls}}, out)
    dist.destroy_process_group()
""")


def _rank_rows(rank):
    idx, preds, target = _rows(10 + rank, 50_000 + 977 * rank, 400)
    idx[:100] = 10**6  # the rows of one query on every rank
    return idx, preds, target


@pytest.mark.cuda
def test_retrieval_gather_across_cards_nccl(cuda, tmp_path):
    world = torch.cuda.device_count()
    if world < 2:
        pytest.skip("needs two or more cards")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    tests = Path(__file__).resolve().parent
    script = tmp_path / "retrieval_worker.py"
    script.write_text(_WORKER.format(repo=str(tests.parent), tests=str(tests)))
    outs = [tmp_path / f"rank{r}.pt" for r in range(world)]
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(world), str(port), str(outs[r])],
                              env=dict(os.environ, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(world)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * world, logs

    one = _collection("cpu", "neg")
    for rank in range(world):
        one.update(*(torch.from_numpy(x) for x in _rank_rows(rank)))
    want = one.compute()
    for out in outs:
        got = torch.load(out)
        for k, v in want.items():
            torch.testing.assert_close(got["values"][k], v, rtol=RTOL, atol=0)
        assert got["calls"] == ["all_gather"] * 3
