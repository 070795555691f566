"""The rest of classification on the card, held against the CPU.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is false.
This file imports no JAX, so it runs on a GPU machine without the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_classification.py

* The confusion matrix at C = 1,000 (``torch.bincount`` of label pairs on the
  card) equals the CPU one exactly: 4,096 x 1,000 probabilities, and integer
  labels up to 1,010 whose pairs past C drop out.
* CalibrationError over 20 batches of 4,096 x 1,000: the per-bin counts and
  accuracy sums equal the CPU run exactly (float32 sums of 0/1 below 2**24 are
  exact), the confidence sums and the value to rtol 1e-5 (``index_add_`` adds
  with atomics on the card, in another order than the CPU).
* The ranking trio and CSI at 4,096 x 80 (tied scores, rows with no true
  label): coverage and the CSI counts exactly, LRAP and ranking loss to rtol
  1e-5 (float32 sums over 4,096 rows in another order).
* On a machine with two or more cards (skips on one): one NCCL process per
  card, each with its own uneven batch, a ``MetricCollection([ConfusionMatrix,
  IoU, CohenKappa])``. The epoch confusion matrix on every rank equals one
  process over all rows exactly; the epoch sync makes 2 ``all_reduce`` calls
  (ConfusionMatrix and IoU are one compute group), and each rank keeps its own
  counts after ``compute()``. IoU agrees to rtol 1e-6 (the same float32 formula
  on equal counts); kappa, ``1 - k`` with ``k`` a ratio of float32 sums over
  C*C terms taken in another order, to rtol 1e-5 plus a few ulps of 1.0
  (atol 1e-6).
"""
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
from metrics_tpu_torch.functional import confusion_matrix

C, N, L = 1_000, 4_096, 80
RTOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _probs(seed, n=N, c=C):
    rng = np.random.default_rng(seed)
    logits = 2 * rng.standard_normal((n, c))
    target = rng.integers(0, c, n)
    logits[np.arange(n), target] += 8
    e = np.exp(logits - logits.max(1, keepdims=True))
    return torch.from_numpy((e / e.sum(1, keepdims=True)).astype(np.float32)), torch.from_numpy(target)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["probs", "labels_out_of_range"])
def test_confusion_matrix_at_imagenet_width_equals_cpu(cuda, kind):
    if kind == "probs":
        preds, target = _probs(1)
    else:
        rng = np.random.default_rng(2)
        preds, target = (torch.from_numpy(rng.integers(0, C + 11, N)) for _ in range(2))
    card = confusion_matrix(preds.to(cuda), target.to(cuda), num_classes=C)
    cpu = confusion_matrix(preds, target, num_classes=C)
    assert torch.equal(card.cpu(), cpu)
    kept = N if kind == "probs" else int(((preds < C) & (target < C)).sum())
    assert int(card.sum()) == kept > 0


@pytest.mark.cuda
def test_calibration_counts_exact_sums_close(cuda):
    card, cpu = pt.CalibrationError(n_bins=15, device=cuda), pt.CalibrationError(n_bins=15, device="cpu")
    for step in range(20):
        preds, target = _probs(100 + step)
        card.update(preds.to(cuda), target.to(cuda))
        cpu.update(preds, target)
    assert torch.equal(card.count.cpu(), cpu.count) and int(cpu.count.sum()) == 20 * N
    assert torch.equal(card.acc_sum.cpu(), cpu.acc_sum)
    torch.testing.assert_close(card.conf_sum.cpu(), cpu.conf_sum, rtol=RTOL, atol=0)
    torch.testing.assert_close(card.compute().cpu(), cpu.compute(), rtol=RTOL, atol=0)


@pytest.mark.cuda
def test_ranking_and_csi_at_coco_width_equal_cpu(cuda):
    rng = np.random.default_rng(3)
    target = (rng.random((N, L)) < 2.9 / L).astype(np.int64)
    logits = rng.standard_normal((N, L)) + 2.0 * target - 1.0
    scores = (np.round(256 / (1 + np.exp(-logits))) / 256).astype(np.float32)
    assert (target.sum(1) == 0).any()  # degenerate rows are in the batch
    p, t = torch.from_numpy(scores), torch.from_numpy(target)
    for name in ("CoverageError", "LabelRankingAveragePrecision", "LabelRankingLoss", "CriticalSuccessIndex"):
        card, cpu = getattr(pt, name)(device=cuda), getattr(pt, name)(device="cpu")
        card.update(p.to(cuda), t.to(cuda))
        cpu.update(p, t)
        for state, value in cpu._current_state().items():
            if value.is_floating_point() and name in ("LabelRankingAveragePrecision", "LabelRankingLoss"):
                torch.testing.assert_close(getattr(card, state).cpu(), value, rtol=RTOL, atol=0)
            else:  # integer counts, and coverage's float32 sum of whole ranks below 2**24
                assert torch.equal(getattr(card, state).cpu(), value), (name, state)
        torch.testing.assert_close(card.compute().cpu(), cpu.compute(), rtol=RTOL, atol=0)


_WORKER = textwrap.dedent("""
    import sys, warnings
    import numpy as np, torch, torch.distributed as dist
    sys.path.insert(0, {repo!r})
    import metrics_tpu_torch as pt

    warnings.simplefilter("ignore")
    rank, world, port, out = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4]
    device = torch.device("cuda", rank)
    torch.cuda.set_device(device)
    dist.init_process_group("nccl", init_method="tcp://127.0.0.1:" + port, rank=rank, world_size=world)
    col = pt.MetricCollection([pt.ConfusionMatrix({c}, device=device), pt.IoU({c}, device=device),
                               pt.CohenKappa({c}, device=device)])
    rng = np.random.default_rng(rank)
    n = {n} + 97 * rank
    preds, target = (torch.from_numpy(rng.integers(0, {c}, n)).to(device) for _ in range(2))
    col.update(preds, target)
    local = col["ConfusionMatrix"].confmat.clone()
    calls = []
    real = dist.all_reduce
    dist.all_reduce = lambda *a, **k: (calls.append(1), real(*a, **k))[1]
    values = col.compute()
    dist.all_reduce = real
    assert torch.equal(col["ConfusionMatrix"].confmat, local)  # each rank keeps its own counts
    torch.save({{"confmat": values["ConfusionMatrix"].cpu(), "iou": values["IoU"].cpu(),
                "kappa": values["CohenKappa"].cpu(), "all_reduce": len(calls)}}, out)
    dist.destroy_process_group()
""")


@pytest.mark.cuda
def test_confusion_matrix_sync_across_cards_nccl(cuda, tmp_path):
    world = torch.cuda.device_count()
    if world < 2:
        pytest.skip("needs two or more cards")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    script = tmp_path / "confmat_worker.py"
    script.write_text(_WORKER.format(repo=str(Path(__file__).resolve().parents[1]), c=C, n=N))
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

    one = pt.MetricCollection([pt.ConfusionMatrix(C, device="cpu"), pt.IoU(C, device="cpu"),
                               pt.CohenKappa(C, device="cpu")])
    for rank in range(world):
        rng = np.random.default_rng(rank)
        one.update(*(torch.from_numpy(rng.integers(0, C, N + 97 * rank)) for _ in range(2)))
    want = one.compute()
    for out in outs:
        got = torch.load(out)
        assert torch.equal(got["confmat"], want["ConfusionMatrix"])
        assert got["all_reduce"] == 2
        torch.testing.assert_close(got["iou"], want["IoU"], rtol=1e-6, atol=0)
        torch.testing.assert_close(got["kappa"], want["CohenKappa"], rtol=RTOL, atol=1e-6)
