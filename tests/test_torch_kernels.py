"""The port's CUDA kernels on the card, held against their plain versions.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is
false, since a CUDA kernel has no CPU mode. This file imports no JAX, so it
also runs on a GPU machine without the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_kernels.py

Bool-weight counts must equal the plain version exactly; float-weight counts
agree to rtol 1e-5 (sums in another order).
"""
import numpy as np
import pytest
import torch

from metrics_tpu_torch.ops.binned import binned_counts_cuda, binned_stat_counts, rank_thresholds


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _inputs(n, t, device, seed):
    rng = np.random.RandomState(seed)
    preds = rng.rand(n).astype(np.float32)
    preds[: min(n, 3)] = np.float32([np.nan, np.inf, -np.inf])[: min(n, 3)]
    pos = rng.rand(n) > 0.5
    thr = rng.permutation(np.linspace(0, 1, t).astype(np.float32))
    return tuple(torch.from_numpy(x).to(device) for x in (preds, pos, thr))


@pytest.mark.cuda
@pytest.mark.parametrize("n,t", [(1, 1), (37, 5), (2049, 64), (100_003, 2047), (200_000, 12_000), (50_000, 20_000)])
def test_kernel_matches_plain_bool_weights(cuda, n, t):
    preds, pos, thr = _inputs(n, t, cuda, seed=n + t)
    before = binned_counts_cuda.launches
    tp, fp = binned_counts_cuda(preds, pos, ~pos, thr)
    assert binned_counts_cuda.launches == before + 1
    ref_tp, ref_fp = binned_stat_counts(preds[:, None], pos[:, None], ~pos[:, None], thr, impl="torch")
    torch.cuda.synchronize()
    assert torch.equal(tp, ref_tp[0]) and torch.equal(fp, ref_fp[0])


@pytest.mark.cuda
def test_kernel_matches_plain_float_weights(cuda):
    preds, pos, thr = _inputs(70_001, 300, cuda, seed=3)
    w = torch.rand(70_001, device=cuda)
    tp, fp = binned_counts_cuda(preds, w, 1 - w, thr)
    ref_tp, ref_fp = binned_stat_counts(preds[:, None], w[:, None], (1 - w)[:, None], thr, impl="torch")
    torch.cuda.synchronize()
    torch.testing.assert_close(tp, ref_tp[0], rtol=1e-5, atol=0)
    torch.testing.assert_close(fp, ref_fp[0], rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_auto_dispatch_launches_the_kernel_for_binary_cuda_input(cuda):
    preds, pos, thr = _inputs(1000, 16, cuda, seed=4)
    before = binned_counts_cuda.launches
    binned_stat_counts(preds[:, None], pos[:, None], ~pos[:, None], thr)
    assert binned_counts_cuda.launches == before + 1
    binned_stat_counts(preds[:, None].repeat(1, 2), pos[:, None].repeat(1, 2), ~pos[:, None].repeat(1, 2), thr)
    binned_stat_counts(preds[:0, None], pos[:0, None], ~pos[:0, None], thr)
    assert binned_counts_cuda.launches == before + 1  # C > 1 and N == 0 take the plain version


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda):
    preds, pos, thr = _inputs(100, 8, cuda, seed=5)
    with pytest.raises(ValueError):
        binned_counts_cuda(preds.cpu(), pos, ~pos, thr)
    with pytest.raises(ValueError):
        binned_counts_cuda(preds.double(), pos, ~pos, thr)
    with pytest.raises(ValueError):
        binned_counts_cuda(preds[::2], pos[::2], ~pos[::2], thr)


def _plain(preds, pos, neg, thr):
    tp, fp = binned_stat_counts(preds[:, None], pos[:, None], neg[:, None], thr, impl="torch")
    return tp[0], fp[0]


def _assert_exact(got, want):
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("n,t", [(1, 1), (100_003, 2047), (200_000, 12_000), (50_000, 20_000)])
def test_ranked_grid_equals_unranked(cuda, n, t):
    preds, pos, thr = _inputs(n, t, cuda, seed=n + 2 * t)
    before = binned_counts_cuda.launches
    unranked = binned_counts_cuda(preds, pos, ~pos, thr)
    ranked = binned_counts_cuda(preds, pos, ~pos, thr, ranked=rank_thresholds(thr))
    assert binned_counts_cuda.launches == before + 2
    torch.cuda.synchronize()
    _assert_exact(ranked, unranked)
    _assert_exact(ranked, _plain(preds, pos, ~pos, thr))


@pytest.mark.cuda
@pytest.mark.parametrize("weights", ["bool", "float"])
def test_back_to_back_calls_each_exact(cuda, weights):
    """50 calls queued with no host sync: the kernel must hand its scratch back zeroed."""
    preds, pos, thr = _inputs(300_001, 2048, cuda, seed=12)
    pw, nw = (pos, ~pos) if weights == "bool" else (pos.float() * 0.5, (~pos).float() * 0.25)
    ranked = rank_thresholds(thr)
    outs = [binned_counts_cuda(preds, pw, nw, thr, ranked=ranked) for _ in range(50)]
    want = _plain(preds, pw, nw, thr)
    torch.cuda.synchronize()
    for got in outs:
        _assert_exact(got, want)  # halves and quarters sum exactly in float64


@pytest.mark.cuda
def test_two_streams_at_once_each_exact(cuda):
    inputs = [_inputs(1_000_003, 2048, cuda, seed=s) for s in (21, 22)]
    wants = [_plain(p, y, ~y, thr) for p, y, thr in inputs]
    ranked = [rank_thresholds(thr) for _, _, thr in inputs]
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    torch.cuda.synchronize()
    outs = [[], []]
    for _ in range(10):
        for i, stream in enumerate(streams):
            with torch.cuda.stream(stream):
                p, y, thr = inputs[i]
                outs[i].append(binned_counts_cuda(p, y, ~y, thr, ranked=ranked[i]))
    torch.cuda.synchronize()
    for i in range(2):
        for got in outs[i]:
            _assert_exact(got, wants[i])


@pytest.mark.cuda
@pytest.mark.parametrize("offsets", [(0, 0), (1, 1), (1, 0), (2, 3)])
@pytest.mark.parametrize("n", [1, 3, 5, 4_194_303, 4_194_305])
def test_lengths_and_unaligned_views(cuda, n, offsets):
    """Views at element offsets (scores, weights): a scalar head, float4 vectors, a scalar tail."""
    off_p, off_w = offsets
    preds, pos, thr = _inputs(n + 3, 2047, cuda, seed=n % 1000 + off_p)
    p = preds[off_p:off_p + n]
    y = pos[off_w:off_w + n]
    neg = (~pos)[off_w:off_w + n]
    got = binned_counts_cuda(p, y, neg, thr, ranked=rank_thresholds(thr))
    torch.cuda.synchronize()
    _assert_exact(got, _plain(p, y, neg, thr))


@pytest.mark.cuda
def test_adversarial_grid_and_scores(cuda):
    """Unsorted grid with -0.0 / +0.0, duplicates, +-inf, subnormals and NaN; scores on every
    threshold and its nextafter neighbours."""
    sub = np.float32(np.finfo(np.float32).smallest_subnormal)
    thr = np.asarray([0.7, -0.0, 0.25, 0.0, np.inf, 0.25, -np.inf, np.nan, sub, -sub, 1.0, 0.7, 0.5, -3.5, 1e30],
                     dtype=np.float32)
    fin = thr[np.isfinite(thr)]
    scores = np.concatenate([thr, np.nextafter(fin, np.float32(np.inf)), np.nextafter(fin, np.float32(-np.inf)),
                             np.float32([0.0, -0.0, 2 * sub, np.nan, np.inf, -np.inf])])
    scores = np.tile(scores, 5000).astype(np.float32)
    y = np.random.RandomState(3).rand(scores.shape[0]) > 0.5
    p, y, th = (torch.from_numpy(x).to(cuda) for x in (scores, y, thr))
    for ranked in (None, rank_thresholds(th)):
        got = binned_counts_cuda(p, y, ~y, th, ranked=ranked)
        torch.cuda.synchronize()
        _assert_exact(got, _plain(p, y, ~y, th))


@pytest.mark.cuda
def test_large_grid_float_weights(cuda):
    preds, pos, thr = _inputs(60_001, 20_000, cuda, seed=8)
    w = torch.rand(60_001, device=cuda)
    tp, fp = binned_counts_cuda(preds, w, 1 - w, thr, ranked=rank_thresholds(thr))
    ref_tp, ref_fp = _plain(preds, w, 1 - w, thr)
    torch.cuda.synchronize()
    torch.testing.assert_close(tp, ref_tp, rtol=1e-5, atol=0)
    torch.testing.assert_close(fp, ref_fp, rtol=1e-5, atol=0)


@pytest.mark.cuda
def test_launch_plan_routes(cuda):
    """T = 2,048 takes shared memory with a 2T-bucket table; T = 20,000 does not fit and searches global."""
    from metrics_tpu_torch.ops.binned import launch_plan

    small, large = launch_plan(2048), launch_plan(20_000)
    assert small["shared_memory_route"] == 1 and small["buckets"] == 4096 and small["resident_blocks"] > 0
    assert large["shared_memory_route"] == 0 and large["resident_blocks"] > 0
