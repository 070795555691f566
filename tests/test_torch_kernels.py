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

from metrics_tpu_torch.ops.binned import binned_counts_cuda, binned_stat_counts


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
@pytest.mark.parametrize("n,t", [(1, 1), (37, 5), (2049, 64), (100_003, 2047), (50_000, 20_000)])
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
