"""The sharded epoch engines on the card.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is false
(the four-card test also where fewer than four cards are visible). This file
imports no JAX, so it runs on a GPU machine without the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_sharded.py

* One card, a one-rank NCCL group: a small N1 (``MetricCollection([AUROC,
  AveragePrecision])`` placed with ``row_sharded()``, 3 steps of 65,536 tied
  scores) and a small N5 (RetrievalMAP / MRR through the regroup) equal the
  same run on the CPU (no process group) within ``RTOL``, with the gather
  functions raising, no gather collective, and one ``all_to_all`` a payload.
* Four cards (NCCL, one process a card): the ring (3 hops) for binary AUROC
  and Kendall, the regroup over 4 destinations for RetrievalMRR and their
  2 x 2 hierarchical forms equal one process's unsharded port within
  ``RTOL``, each rank's NCCL ``batch_isend_irecv`` taking the global peer
  rank inside the ``ici`` subgroup.

Tolerances: float32 values of equal counts, summed in another order, within ``RTOL``.
"""
import contextlib
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

import metrics_tpu_torch as pt
import metrics_tpu_torch.core.metric as pmetric
import metrics_tpu_torch.parallel.buffer as pbuffer
import metrics_tpu_torch.parallel.sync as psync
from metrics_tpu_torch.observability import counters
from metrics_tpu_torch.parallel import row_sharded

RTOL = 1e-6
_REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@contextlib.contextmanager
def _one_rank_nccl():
    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=1, rank=0)
    counters.reset()
    try:
        yield
    finally:
        counters.disable()
        dist.destroy_process_group()


@contextlib.contextmanager
def _no_gather():
    def boom(*_a, **_k):
        raise AssertionError("the sharded compute gathered the epoch")

    saved = (pbuffer.buffer_values, pbuffer.buffer_all_gather, psync.host_gather, pmetric.host_gather)
    pbuffer.buffer_values = pbuffer.buffer_all_gather = psync.host_gather = pmetric.host_gather = boom
    try:
        yield
    finally:
        pbuffer.buffer_values, pbuffer.buffer_all_gather, psync.host_gather, pmetric.host_gather = saved


def _curve_batches():
    rng = np.random.default_rng(3)
    out = []
    for _ in range(3):
        t = (rng.random(65_536) < 0.1).astype(np.int64)
        s = np.round(4096 / (1 + np.exp(-(rng.standard_normal(65_536) + 1.5 * t)))) / 4096
        out.append((s.astype(np.float32), t))
    return out


def _retrieval_batches():
    rng = np.random.default_rng(6)
    return [(rng.integers(0, 500, 50_000), rng.random(50_000, dtype=np.float32),
             (rng.random(50_000) < 0.2).astype(np.int64)) for _ in range(2)]


def _run(make, batches, device, place):
    col = make(device)
    if place:
        col.device_put(row_sharded())
    for batch in batches:
        col.update(*(torch.from_numpy(x).to(device) for x in batch))
    counters.reset()
    counters.enable()
    with _no_gather() if place else contextlib.nullcontext():
        values = {k: float(v) for k, v in col.compute().items()}
    calls = dict(counters.snapshot()["calls_by_kind"])
    counters.disable()
    return values, calls


def _curves(device):
    return pt.MetricCollection([pt.AUROC(pos_label=1, device=device, capacity=262_144),
                                pt.AveragePrecision(pos_label=1, device=device, capacity=262_144)])


def _retrieval(device):
    return pt.MetricCollection([pt.RetrievalMAP(device=device, capacity=131_072),
                                pt.RetrievalMRR(device=device, capacity=131_072)])


@pytest.mark.cuda
def test_small_n1_and_n5_on_the_card_equal_the_cpu(cuda):
    cpu_curves, _ = _run(_curves, _curve_batches(), torch.device("cpu"), place=True)
    cpu_retrieval, _ = _run(_retrieval, _retrieval_batches(), torch.device("cpu"), place=True)
    with _one_rank_nccl():
        card_curves, curve_calls = _run(_curves, _curve_batches(), cuda, place=True)
        gathered, gather_calls = _run(_curves, _curve_batches(), cuda, place=False)
        card_retrieval, retrieval_calls = _run(_retrieval, _retrieval_batches(), cuda, place=True)
    for k, v in cpu_curves.items():
        np.testing.assert_allclose(card_curves[k], v, rtol=RTOL)
        np.testing.assert_allclose(card_curves[k], gathered[k], rtol=RTOL)
    for k, v in cpu_retrieval.items():
        np.testing.assert_allclose(card_retrieval[k], v, rtol=RTOL)
    assert "all_gather" not in curve_calls and "ppermute" not in curve_calls, curve_calls  # one rank: no hop
    assert gather_calls.get("all_gather", 0) > 0
    assert retrieval_calls.get("all_to_all") == 8 and "all_gather" not in retrieval_calls, retrieval_calls


_WORKER = textwrap.dedent("""
    import json, sys
    import numpy as np, torch, torch.distributed as dist
    sys.path.insert(0, sys.argv[4])
    import metrics_tpu_torch as pt
    from metrics_tpu_torch.parallel import sharded_epoch as se

    rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.cuda.set_device(rank)
    dev = torch.device("cuda", rank)
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:{port}", world_size=4, rank=rank)
    h = pt.parallel.hierarchical_mesh(slices=2)
    rng = np.random.RandomState(7)
    n = 16_384
    d = {"p": np.round(rng.rand(n), 2).astype(np.float32), "t": (rng.rand(n) < 0.3).astype(np.int64),
         "x": np.round(rng.rand(n), 2).astype(np.float32), "idx": rng.randint(0, 300, n).astype(np.int64),
         "rp": rng.rand(n).astype(np.float32)}
    d["y"] = np.round(d["x"] + 0.5 * rng.randn(n), 2).astype(np.float32)
    m = n // 4
    b = {k: torch.from_numpy(v[rank * m:(rank + 1) * m]).to(dev) for k, v in d.items()}
    res = {}
    for tag, g in (("flat", None), ("hier", h)):
        res[tag] = {"auroc": float(se.sharded_auroc(b["p"], b["t"], g)),
                    "kendall": float(se.sharded_kendall(b["x"], b["y"], g)),
                    "mrr": float(se.sharded_retrieval_sums(pt.RetrievalMRR(device=dev), b["idx"], b["rp"], b["t"],
                                                           g)[0])}
    json.dump(res, open(out, "w"))
    dist.destroy_process_group()
""")


@pytest.mark.cuda
def test_ring_and_regroup_on_four_cards(cuda, tmp_path):
    if torch.cuda.device_count() < 4:
        pytest.skip(f"needs 4 CUDA devices, have {torch.cuda.device_count()}")
    script = tmp_path / "worker.py"
    script.write_text(_WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(port), str(tmp_path / f"out{r}.json"),
                               str(_REPO)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=dict(os.environ, OMP_NUM_THREADS="1"))
             for r in range(4)]
    try:
        logs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * 4, logs
    rng = np.random.RandomState(7)
    n = 16_384
    p, t = np.round(rng.rand(n), 2).astype(np.float32), (rng.rand(n) < 0.3).astype(np.int64)
    x = np.round(rng.rand(n), 2).astype(np.float32)
    idx, rp = rng.randint(0, 300, n).astype(np.int64), rng.rand(n).astype(np.float32)
    y = np.round(x + 0.5 * rng.randn(n), 2).astype(np.float32)
    want = {}
    for name, metric, args in (("auroc", pt.AUROC(pos_label=1, device="cpu"), (p, t)),
                               ("kendall", pt.KendallRankCorrCoef(device="cpu"), (x, y)),
                               ("mrr", pt.RetrievalMRR(device="cpu"), (idx, rp, t))):
        metric.update(*(torch.from_numpy(a) for a in args))
        want[name] = float(metric.compute())
    for r in range(4):
        res = json.loads((tmp_path / f"out{r}.json").read_text())
        for tag in ("flat", "hier"):
            for name, value in want.items():
                np.testing.assert_allclose(res[tag][name], value, rtol=RTOL, err_msg=f"rank {r} {tag} {name}")
