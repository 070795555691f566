"""Kernel K2, the SSIM family's filter, on the card, held against its plain version there.

Marked ``cuda``: each test skips where ``torch.cuda.is_available()`` is false,
since a CUDA kernel has no CPU mode. This file imports no JAX, so it runs on a
GPU machine without the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda_ssim_kernel.py

The plain version is the same module's torch chain run on the same CUDA
tensors (``_ssim_map``, UQI's ops). K2 repeats its arithmetic: the taps in
order, fused as PyTorch's CUDA ``add(alpha=)`` fuses them, the passes along H
then W, each pointwise op rounded on its own. So its maps equal the plain
version's bit for bit; its per-block sums add the same pixels in another order
than a float64 sum of the plain maps, and are held to ``RTOL_SUM``.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import metrics_tpu_torch as pt
import metrics_tpu_torch.functional as ptf
from metrics_tpu_torch.functional.regression.ssim import _ssim_map, _window_taps
from metrics_tpu_torch.functional.regression.uqi import _uqi_map
from metrics_tpu_torch.ops.ssim_filter import launch_plan, ssim_filter_cuda

RTOL_SUM = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", 0)


def _images(seed, shape, device):
    rng = np.random.default_rng(seed)
    n, c, h, w = shape
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    target = 0.5 + 0.25 * np.sin(8 * yy + rng.random((n, c, 1, 1)) * 6) * np.cos(7 * xx)
    preds = np.clip(target + 0.05 * rng.standard_normal(shape), 0, 1)
    return (torch.from_numpy(x.astype(np.float32)).to(device) for x in (preds, target))


def _kernel(p, t, window, sigma, maps, **kw):
    taps_h, taps_w = _window_taps(tuple(window), tuple(sigma))
    return ssim_filter_cuda(p, t, taps_h, taps_w, maps=maps, **kw)


def _check_both_modes(p, t, window, sigma, want_maps, **kw):
    """K2's maps against the plain maps, and its per-block sums against the plain maps' per-image sums."""
    got_maps = _kernel(p, t, window, sigma, True, **kw)
    sums = _kernel(p, t, window, sigma, False, **kw)
    torch.cuda.synchronize()
    assert got_maps.shape == want_maps.shape
    assert torch.equal(got_maps, want_maps), float((got_maps - want_maps).abs().max())
    plan = launch_plan(p.shape, window)
    assert sums.shape == (want_maps.shape[0], *plan["partials"])
    torch.testing.assert_close(sums.sum(-1), want_maps.double().sum(dim=(2, 3, 4)).float(), rtol=RTOL_SUM, atol=1e-3)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [16, 8])
def test_ssim_maps_and_sums_equal_plain_at_every_ms_ssim_scale(cuda, batch):
    p, t = _images(batch, (batch, 3, 512, 512), cuda)
    window, sigma = (11, 11), (1.5, 1.5)
    for scale in range(5):
        want = torch.stack(_ssim_map(p, t, window, sigma, 1.0, 0.01, 0.03))
        _check_both_modes(p, t, window, sigma, want, data_range=1.0)
        p, t = F.avg_pool2d(p, 2), F.avg_pool2d(t, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 3, 257, 263), (2, 1, 7, 11), (1, 2, 45, 33)])
def test_non_square_window_and_odd_sides(cuda, shape):
    p, t = _images(1, shape, cuda)
    window, sigma = (7, 11), (1.0, 2.0)
    want = torch.stack(_ssim_map(p, t, window, sigma, 1.0, 0.01, 0.03))
    _check_both_modes(p, t, window, sigma, want, data_range=1.0)
    shift = torch.mean((p + t) * 0.5)
    _check_both_modes(p, t, window, sigma, _uqi_map(p, t, window, sigma, shift)[None], shift=shift)


@pytest.mark.cuda
def test_longest_window(cuda):
    p, t = _images(2, (2, 3, 70, 67), cuda)
    window, sigma = (31, 31), (4.0, 3.0)
    want = torch.stack(_ssim_map(p, t, window, sigma, 2.0, 0.01, 0.03))
    _check_both_modes(p, t, window, sigma, want, data_range=2.0)


@pytest.mark.cuda
def test_uqi_flat_branch(cuda):
    """Constant windows: equal levels, different levels, zeros, and one noisy channel beside flat ones."""
    n, c, h, w = 4, 3, 48, 40
    p = torch.full((n, c, h, w), 0.25, device=cuda)
    t = torch.full((n, c, h, w), 0.25, device=cuda)
    t[1] = 0.75
    p[2] = t[2] = 0.0
    noisy, _ = _images(3, (1, 1, h, w), cuda)
    p[3, 0] = noisy[0, 0]
    window, sigma = (11, 11), (1.5, 1.5)
    shift = torch.mean((p + t) * 0.5)
    want = _uqi_map(p, t, window, sigma, shift)[None]
    _check_both_modes(p, t, window, sigma, want, shift=shift)
    got = ptf.universal_image_quality_index(p, t, reduction="none")
    assert torch.equal(got[0], torch.ones_like(got[0])) and torch.equal(got[2], torch.ones_like(got[2]))


@pytest.mark.cuda
def test_data_range_as_a_device_tensor(cuda):
    p, t = _images(4, (3, 3, 96, 80), cuda)
    p = p * 3.0
    data_range = torch.maximum(p.max() - p.min(), t.max() - t.min())
    want = torch.stack(_ssim_map(p, t, (11, 11), (1.5, 1.5), data_range, 0.01, 0.03))
    _check_both_modes(p, t, (11, 11), (1.5, 1.5), want, data_range=data_range)
    got = ptf.ssim(p, t, reduction="none")  # data_range inferred on the card, read there
    assert torch.equal(got, want[0])


@pytest.mark.cuda
def test_two_runs_are_bit_equal(cuda):
    p, t = _images(5, (16, 3, 512, 512), cuda)
    for kw in ({"data_range": 1.0}, {"shift": torch.mean((p + t) * 0.5)}):
        for maps in (False, True):
            first = _kernel(p, t, (11, 11), (1.5, 1.5), maps, **kw)
            second = _kernel(p, t, (11, 11), (1.5, 1.5), maps, **kw)
            assert torch.equal(first, second)
    assert torch.equal(ptf.multiscale_ssim(p, t, data_range=1.0, reduction="none"),
                       ptf.multiscale_ssim(p, t, data_range=1.0, reduction="none"))


@pytest.mark.cuda
def test_launches_and_plain_calls_count_the_cell_step(cuda):
    """The benchmark cell's image collection: 7 launches a step (SSIM 1, MS-SSIM 5, UQI 1), no plain call."""
    col = pt.MetricCollection([
        pt.SSIM(data_range=1.0, device=cuda), pt.MultiScaleSSIM(data_range=1.0, device=cuda),
        pt.PSNR(data_range=1.0, device=cuda), pt.UniversalImageQualityIndex(device=cuda),
        pt.TotalVariation(device=cuda), pt.SpectralAngleMapper(device=cuda),
        pt.ErrorRelativeGlobalDimensionlessSynthesis(device=cuda),
    ])
    p, t = _images(6, (4, 3, 512, 512), cuda)
    before = ssim_filter_cuda.launches, ssim_filter_cuda.plain_cuda_calls
    for _ in range(3):
        col(preds=p, target=t, img=p)
    assert (ssim_filter_cuda.launches - before[0], ssim_filter_cuda.plain_cuda_calls - before[1]) == (21, 0)
    before = ssim_filter_cuda.launches
    stored = pt.SSIM(device=cuda)
    stored.update(p, t)
    stored.compute()
    assert ssim_filter_cuda.launches == before + 1  # the stored mode launches at compute()


@pytest.mark.cuda
def test_a_call_makes_no_synchronizing_call(cuda):
    p, t = _images(7, (4, 3, 128, 128), cuda)
    ssim_mod = pt.SSIM(data_range=1.0, device=cuda)
    calls = (
        lambda: ptf.ssim(p, t, data_range=1.0),
        lambda: ptf.ssim(p, t),
        lambda: ptf.ssim(p, t, reduction="none"),
        lambda: ptf.multiscale_ssim(p, t, kernel_size=(5, 5), data_range=1.0),
        lambda: ptf.universal_image_quality_index(p, t),
        lambda: ssim_mod.update(p, t),
    )
    for call in calls:
        call()  # built and warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for call in calls:
            call()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
