"""Sketch states on the card, held against the CPU run of the port.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is false.
This file imports no JAX, so it runs on a GPU machine without the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_sketch.py

* The qsketch bucket on the card equals the CPU's on every edge of the three
  grids of record and the float32 values 1 and 2 ulps either side of it, both
  signs, and on 4,000,000 log-uniform values: it bins by comparison with
  float32 edges, so the card's ``searchsorted`` decides every value as the CPU
  does (a ``logf`` on the card would not).
* The linear and soft-sign grids' bins and every update's counts (curve, joint,
  value and count-min) equal the CPU run bit for bit; integer atomics are exact
  in any order.
* A metric step (a forward: update, merge, batch value) and an epoch
  ``compute()`` of every sketch metric make no synchronizing CUDA call
  (``torch.cuda.set_sync_debug_mode("error")``).

Tolerances: bins and counts are integers and equal; values computed from equal
counts by the same float64 math agree to rtol 1e-6 (reductions in another order).
"""
import warnings

import numpy as np
import pytest
import torch

import metrics_tpu_torch as pt
from metrics_tpu_torch.parallel import qsketch as qs
from metrics_tpu_torch.parallel import sketch as sk
from metrics_tpu_torch.parallel.cms import cms_buckets, cms_scatter, stable_key_hash_array

RTOL = 1e-6
_GRIDS = [(0.01, 1e-9, 1e9), (0.1, 1e-6, 1e6), (0.01, 1e-6, 1e6)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _edge_ring(grid):
    m = (qs.qsketch_num_buckets(*grid) - 3) // 2
    gamma = (1 + grid[0]) / (1 - grid[0])
    e = (grid[1] * gamma ** np.arange(m + 1, dtype=np.float64)).astype(np.float32)
    up1, dn1 = np.nextafter(e, np.float32(np.inf)), np.nextafter(e, np.float32(-np.inf))
    ring = np.concatenate([e, up1, dn1, np.nextafter(up1, np.float32(np.inf)), np.nextafter(dn1, np.float32(-np.inf))])
    return np.concatenate([ring, -ring, np.float32([0.0, -0.0, np.inf, -np.inf])])


@pytest.mark.cuda
@pytest.mark.parametrize("grid", _GRIDS)
def test_qsketch_bucket_on_the_card_equals_cpu_on_every_edge(cuda, grid):
    rng = np.random.default_rng(1)
    n = 4_000_000
    x = np.concatenate([_edge_ring(grid), (10 ** rng.uniform(np.log10(grid[1]) - 1, np.log10(grid[2]) + 1, n)
                                           * rng.choice([-1, 1], n)).astype(np.float32)])
    cpu = qs.qsketch_bucket(torch.from_numpy(x), *grid)
    card = qs.qsketch_bucket(torch.from_numpy(x).to(cuda), *grid)
    assert torch.equal(card.cpu(), cpu)


@pytest.mark.cuda
def test_linear_and_rank_bins_and_every_update_equal_cpu(cuda):
    rng = np.random.default_rng(2)
    n = 1_000_000
    target = (rng.random(n) < 0.3).astype(np.int64)
    scores = (1 / (1 + np.exp(-(rng.standard_normal(n) + target)))).astype(np.float32)
    scores[:4] = [np.nan, np.inf, -np.inf, 1.0]
    values = (rng.lognormal(0.0, 2.0, n) * rng.choice([-1, 1], n)).astype(np.float32)
    values[:3] = [np.nan, np.inf, 0.0]
    mc = rng.random((4_096, 100)).astype(np.float32)
    labels = rng.integers(0, 100, 4_096)
    logits = np.log(scores[4:] / (1 - scores[4:])).astype(np.float32)
    b, bq = qs.qsketch_num_buckets(0.1, 1e-6, 1e6), qs.qsketch_num_buckets(0.01, 1e-6, 1e6)
    cases = [
        (lambda x: sk.score_to_bin(x, 2048, 0.0, 1.0), (scores,)),
        (lambda x: sk.rank_to_bin(x, 512, None, None), (values,)),
        (lambda p, t: sk.sketch_curve_update(torch.zeros(2, 2048, dtype=torch.int64, device=p.device), p, t, 0.0,
                                             1.0, 1), (scores, target)),
        (lambda p, t: sk.sketch_curve_update(torch.zeros(100, 2, 512, dtype=torch.int64, device=p.device), p, t,
                                             0.0, 1.0, 1), (mc, labels)),
        (lambda p, t: qs.qsketch_curve_update(torch.zeros(2, bq, dtype=torch.int64, device=p.device), p, t, 0.01,
                                              1e-6, 1e6, 1), (logits, target[4:])),
        (lambda p, t: sk.sketch_rank_update(torch.zeros(512, 512, dtype=torch.int64, device=p.device), p, t, None,
                                            None), (values, np.abs(values))),
        (lambda p, t: qs.qsketch_rank_update(torch.zeros(b, b, dtype=torch.int64, device=p.device), p, t, 0.1, 1e-6,
                                             1e6), (values, np.abs(values))),
        (lambda x: qs.qsketch_update(torch.zeros(4149, dtype=torch.int64, device=x.device), x, 0.01, 1e-9, 1e9),
         (values,)),
    ]
    for i, (fn, args) in enumerate(cases):
        cpu = fn(*(torch.from_numpy(a) for a in args))
        card = fn(*(torch.from_numpy(a).to(cuda) for a in args))
        assert torch.equal(card.cpu(), cpu), f"case {i}"
    keys = rng.zipf(1.1, n) % 1_000_000
    buckets = torch.from_numpy(cms_buckets(stable_key_hash_array(keys), 4, 4096, 29))
    ones = torch.ones(n, dtype=torch.int64)
    cpu = cms_scatter(torch.zeros(4, 4096, dtype=torch.int64), buckets, ones)
    card = cms_scatter(torch.zeros(4, 4096, dtype=torch.int64, device=cuda), buckets.to(cuda), ones.to(cuda))
    assert torch.equal(card.cpu(), cpu)


def _metrics(device):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return {
            "curves": (pt.MetricCollection([pt.AUROC(approx="sketch", device=device),
                                            pt.AveragePrecision(approx="sketch", device=device),
                                            pt.ROC(approx="sketch", device=device),
                                            pt.PrecisionRecallCurve(approx="sketch", device=device)]), "scores"),
            "qcurves": (pt.MetricCollection([pt.AUROC(approx="qsketch", device=device),
                                             pt.AveragePrecision(approx="qsketch", device=device)]), "logits"),
            "multiclass": (pt.MetricCollection([pt.AUROC(approx="sketch", num_classes=100, device=device),
                                                pt.AveragePrecision(approx="sketch", num_classes=100,
                                                                    device=device)]), "probs"),
            "ranks": (pt.MetricCollection([pt.SpearmanCorrcoef(approx="sketch", device=device),
                                           pt.KendallRankCorrCoef(approx="sketch", device=device)]), "pairs"),
            "qranks": (pt.MetricCollection([pt.SpearmanCorrcoef(approx="qsketch", device=device),
                                            pt.KendallRankCorrCoef(approx="qsketch", device=device)]), "pairs"),
            "quantiles": (pt.MetricCollection([pt.Quantile(q=(0.5, 0.99), device=device),
                                               pt.Percentile(99.9, device=device)]), "values"),
            "mae": (pt.MetricCollection([pt.MedianAbsoluteError(device=device)]), "pairs"),
        }


def _inputs(device):
    rng = np.random.default_rng(3)
    n = 200_000
    target = (rng.random(n) < 0.3).astype(np.int64)
    scores = (1 / (1 + np.exp(-(rng.standard_normal(n) + target)))).astype(np.float32)
    t = rng.lognormal(0.0, 1.0, n).astype(np.float32)
    arrays = {
        "scores": (scores, target),
        "logits": (np.log(scores / (1 - scores)).astype(np.float32), target),
        "probs": (rng.random((2_048, 100)).astype(np.float32), rng.integers(0, 100, 2_048)),
        "pairs": ((t * np.exp(0.1 * rng.standard_normal(n))).astype(np.float32), t),
        "values": (t,),
    }
    return {k: tuple(torch.from_numpy(a).to(device) for a in v) for k, v in arrays.items()}


def _close(a, b):
    if isinstance(a, (list, tuple)):
        for x, y in zip(a, b):
            _close(x, y)
        return
    np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=RTOL, atol=1e-7)


@pytest.mark.cuda
def test_sketch_metrics_equal_cpu_and_make_no_synchronizing_call(cuda):
    card, cpu = _metrics(cuda), _metrics("cpu")
    on_card, on_cpu = _inputs(cuda), _inputs("cpu")
    for name, (col, kind) in card.items():
        col(*on_card[kind])  # the first call builds the cached grid constants
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            step = col(*on_card[kind])
            epoch = col.compute()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        ref_col = cpu[name][0]
        ref_col(*on_cpu[kind])
        ref_step = ref_col(*on_cpu[kind])
        for k in step:
            _close(step[k], ref_step[k])
            _close(epoch[k], ref_col.compute()[k])
        for k, m in col.items():
            for state, value in m._current_state().items():
                assert torch.equal(value.counts.cpu(), ref_col[k]._current_state()[state].counts), f"{name} {k}"
