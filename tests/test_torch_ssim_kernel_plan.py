"""Kernel K2 (the SSIM family's filter) as far as the CPU can check it.

The kernel itself runs only on a card (``tests/test_torch_cuda_ssim_kernel.py``).
Here, without ``nvcc``:

* the dispatch rule (:func:`filter_takes`) as a pure function of device,
  dtype, shape and window;
* the launch plan: output extent, tiles, halo, blocks, the
  ``(N, blocks_per_image)`` layout of the partial sums;
* the wrapper raising on what the kernel does not take, before it loads the
  library;
* the premise of the kernel's indexing: the plain version's cropped moment
  maps are the valid correlation of the unpadded images (the reflection never
  reaches a kept pixel);
* the glue of the kernel's path (reductions, MS-SSIM's per-image means from
  per-block sums, UQI's shift, the modules' sums and counts), with a CPU model
  of the kernel's output contract put in its place: equal to the plain path to
  float32 summation order (rtol 1e-6);
* CPU tensors never reach the kernel, and the counters do not move for them.
"""
import importlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import metrics_tpu_torch as pt
import metrics_tpu_torch.functional as ptf
from metrics_tpu_torch.functional.regression.ssim import (
    _gaussian,
    _map_numel,
    _moment_maps,
    _ssim_map,
    _window_taps,
)
from metrics_tpu_torch.functional.regression.uqi import _uqi_map
from metrics_tpu_torch.ops import ssim_filter as k2_ops
from metrics_tpu_torch.ops.ssim_filter import filter_takes, launch_plan, ssim_filter_cuda

CUDA = torch.device("cuda", 0)  # a device object only: nothing here allocates on it
ssim_mod = importlib.import_module("metrics_tpu_torch.functional.regression.ssim")  # the package exports `ssim`


def _images(seed, shape, dtype=np.float32):
    rng = np.random.default_rng(seed)
    n, c, h, w = shape
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    target = 0.5 + 0.25 * np.sin(8 * yy + rng.random((n, c, 1, 1)) * 6) * np.cos(7 * xx)
    preds = np.clip(target + 0.05 * rng.standard_normal(shape), 0, 1)
    return torch.from_numpy(preds.astype(dtype)), torch.from_numpy(target.astype(dtype))


@pytest.mark.parametrize("device,dtype,shape,window,takes", [
    (CUDA, torch.float32, (16, 3, 512, 512), (11, 11), True),
    ("cuda", torch.float32, (8, 3, 512, 512), (11, 11), True),
    (CUDA, torch.float32, (16, 3, 32, 32), (11, 11), True),  # MS-SSIM's coarsest scale of a 512 crop
    (CUDA, torch.float32, (4, 3, 257, 263), (7, 11), True),
    (CUDA, torch.float32, (1, 1, 31, 31), (31, 31), True),  # the longest side, as long as the image
    (CUDA, torch.float32, (1, 1, 64, 64), (33, 11), False),  # a side past the shared-memory plan
    (CUDA, torch.float32, (1, 1, 64, 64), (11, 33), False),
    (CUDA, torch.float64, (16, 3, 512, 512), (11, 11), False),
    (CUDA, torch.float16, (16, 3, 512, 512), (11, 11), False),
    ("cpu", torch.float32, (16, 3, 512, 512), (11, 11), False),
    (CUDA, torch.float32, (1, 1, 10, 64), (11, 11), False),  # empty map: the plain version's nan
    (CUDA, torch.float32, (1, 1, 64, 10), (11, 11), False),
    (CUDA, torch.float32, (0, 3, 64, 64), (11, 11), False),
    (CUDA, torch.float32, (3, 64, 64), (11, 11), False),
])
def test_dispatch_rule(device, dtype, shape, window, takes):
    assert filter_takes(device, dtype, shape, window) is takes


@pytest.mark.parametrize("shape,window,want", [
    # the cell: SSIM / UQI and MS-SSIM's scale 0, then its pooled scales 1-4
    ((16, 3, 512, 512), (11, 11), dict(out_h=502, out_w=502, tiles_h=16, tiles_w=16, blocks=12_288,
                                        partials=(16, 768))),
    ((16, 3, 256, 256), (11, 11), dict(out_h=246, out_w=246, tiles_h=8, tiles_w=8, blocks=3_072, partials=(16, 192))),
    ((16, 3, 128, 128), (11, 11), dict(out_h=118, out_w=118, tiles_h=4, tiles_w=4, blocks=768, partials=(16, 48))),
    ((16, 3, 64, 64), (11, 11), dict(out_h=54, out_w=54, tiles_h=2, tiles_w=2, blocks=192, partials=(16, 12))),
    ((16, 3, 32, 32), (11, 11), dict(out_h=22, out_w=22, tiles_h=1, tiles_w=1, blocks=48, partials=(16, 3))),
    ((8, 3, 512, 512), (11, 11), dict(blocks=6_144, partials=(8, 768))),  # the pass's last batch
    ((4, 3, 257, 263), (7, 11), dict(out_h=251, out_w=253, tiles_h=8, tiles_w=8, halo=(6, 10), partials=(4, 192))),
    ((2, 1, 40, 40), (31, 31), dict(out_h=10, out_w=10, tiles_h=1, tiles_w=1, blocks=2, partials=(2, 1))),
    ((1, 1, 31, 31), (31, 31), dict(out_h=1, out_w=1, tiles_h=1, tiles_w=1, blocks=1, partials=(1, 1))),
    ((3, 2, 97, 33), (1, 31), dict(out_h=97, out_w=3, tiles_h=4, tiles_w=1, halo=(0, 30), partials=(3, 8))),
])
def test_launch_plan(shape, window, want):
    plan = launch_plan(shape, window)
    for key, value in want.items():
        assert plan[key] == value, key
    assert plan["halo"] == (window[0] - 1, window[1] - 1)
    assert plan["tiles_h"] * k2_ops.TILE_H >= plan["out_h"] > (plan["tiles_h"] - 1) * k2_ops.TILE_H
    assert plan["tiles_w"] * k2_ops.TILE_W >= plan["out_w"] > (plan["tiles_w"] - 1) * k2_ops.TILE_W
    assert plan["blocks"] == shape[0] * plan["partials"][1]


@pytest.fixture
def no_library(monkeypatch):
    def refuse(*_a, **_k):
        raise AssertionError("the wrapper loaded the library before checking its inputs")

    monkeypatch.setattr(k2_ops, "_library", refuse)


_TAPS = _window_taps((11, 11), (1.5, 1.5))


@pytest.mark.parametrize("case,match", [
    ("non_contiguous", "contiguous"), ("float64", "float32 images"), ("float16", "float32 images"),
    ("shape_mismatch", "one shape"), ("three_d", "NCHW"), ("cpu", "CUDA tensors"), ("even_window", "window"),
    ("long_window", "window"), ("image_shorter_than_window", "window"), ("uqi_with_data_range", "no data_range"),
    ("ssim_without_data_range", "needs a data_range"), ("shift_of_two_values", "`shift`"),
    ("data_range_float64", "`data_range`"),
])
def test_wrapper_raises_before_any_launch(no_library, case, match):
    p, t = _images(0, (2, 3, 64, 64))
    taps_h, taps_w = _TAPS
    kw = {"data_range": 1.0}
    if case == "non_contiguous":
        p, t = p.transpose(2, 3), t.transpose(2, 3)
    elif case in ("float64", "float16"):
        p, t = p.to(getattr(torch, case)), t.to(getattr(torch, case))
    elif case == "shape_mismatch":
        t = t[:, :, :32].contiguous()
    elif case == "three_d":
        p, t = p[0], t[0]
    elif case == "even_window":
        taps_h = taps_h[:10]
    elif case == "long_window":
        taps_h = tuple(_gaussian(33, 5.0, torch.float32).tolist())
    elif case == "image_shorter_than_window":
        p, t = p[..., :8].contiguous(), t[..., :8].contiguous()
    elif case == "uqi_with_data_range":
        kw = {"data_range": 1.0, "shift": torch.zeros(())}
    elif case == "ssim_without_data_range":
        kw = {}
    elif case == "shift_of_two_values":
        kw = {"shift": torch.zeros(2)}
    elif case == "data_range_float64":
        kw = {"data_range": torch.ones((), dtype=torch.float64)}
    with pytest.raises(ValueError, match=match):
        ssim_filter_cuda(p, t, taps_h, taps_w, **kw)


def test_window_taps_are_the_plain_gaussian():
    for size, sigma in (((11, 11), (1.5, 1.5)), ((7, 11), (1.0, 2.0))):
        taps_h, taps_w = _window_taps(size, sigma)
        assert taps_h == tuple(_gaussian(size[0], sigma[0], torch.float32).tolist())
        assert taps_w == tuple(_gaussian(size[1], sigma[1], torch.float32).tolist())


@pytest.mark.parametrize("shape,window,sigma", [
    ((2, 3, 48, 40), (11, 11), (1.5, 1.5)),
    ((1, 2, 33, 47), (7, 11), (1.0, 2.0)),
    ((1, 1, 11, 13), (11, 13), (1.5, 2.5)),  # one output pixel
])
def test_cropped_moments_are_the_valid_correlation_of_the_unpadded_images(shape, window, sigma):
    """What lets K2 read only in-range pixels: the crop removes exactly the ring the reflect pad reached."""
    p, t = (x.double() for x in _images(3, shape))
    got = _moment_maps(p, t, window, sigma)
    g = _gaussian(window[0], sigma[0], torch.float64)[:, None] * _gaussian(window[1], sigma[1], torch.float64)[None, :]
    n, c, h, w = shape
    kern = g.expand(c, 1, *window)

    def corr(x):
        return F.conv2d(x, kern, groups=c)  # valid extent, no padding

    mu_p, mu_t = corr(p), corr(t)
    want = (mu_p, mu_t, corr(p * p) - mu_p**2, corr(t * t) - mu_t**2, corr(p * t) - mu_p * mu_t)
    for a, b in zip(got, want):
        assert a.shape == (n, c, h - window[0] + 1, w - window[1] + 1)
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)


@pytest.mark.parametrize("shape,window", [((2, 3, 48, 40), (11, 11)), ((1, 1, 11, 13), (11, 13)),
                                          ((1, 1, 8, 20), (11, 11)), ((2, 1, 20, 6), (3, 7))])
def test_map_numel_is_the_plain_maps(shape, window):
    p, t = _images(4, shape)
    ssim_idx, _ = _ssim_map(p, t, window, (1.5, 1.5), 1.0, 0.01, 0.03)
    assert _map_numel(shape, window) == ssim_idx.numel()


_SIGMA_OF = {_window_taps(size, sigma): sigma for size, sigma in (((11, 11), (1.5, 1.5)), ((7, 11), (1.0, 2.0)),
                                                                   ((5, 5), (1.5, 1.5)), ((3, 3), (1.5, 1.5)))}


class _ModelKernel:
    """K2's output contract computed by the plain version on the CPU, put in the kernel's place: the maps, or
    each 32 x 32 tile's sums laid out ``(M, N, C * tiles_h * tiles_w)`` as ``launch_plan`` says. ``plain``
    sends the reference's calls to the plain path."""

    def __init__(self):
        self.plain = False
        self.calls = []

    def takes(self, device, dtype, shape, window):
        return not self.plain and len(shape) == 4

    def launch(self, preds, target, taps_h, taps_w, *, data_range=None, k1=0.01, k2=0.03, shift=None, maps=False):
        self.calls.append(maps)
        window, sigma = (len(taps_h), len(taps_w)), _SIGMA_OF[(taps_h, taps_w)]
        if shift is None:
            out = torch.stack(_ssim_map(preds, target, window, sigma, data_range, k1, k2))
        else:
            out = _uqi_map(preds, target, window, sigma, shift)[None]
        if maps:
            return out
        plan = launch_plan(preds.shape, window)
        m, n, c, oh, ow = out.shape
        padded = F.pad(out, (0, plan["tiles_w"] * k2_ops.TILE_W - ow, 0, plan["tiles_h"] * k2_ops.TILE_H - oh))
        tiles = padded.reshape(m, n, c, plan["tiles_h"], k2_ops.TILE_H, plan["tiles_w"], k2_ops.TILE_W).sum(dim=(4, 6))
        return tiles.reshape(m, *plan["partials"])

    def reference(self, fn):
        self.plain = True
        try:
            return fn()
        finally:
            self.plain = False


@pytest.fixture
def model_kernel(monkeypatch):
    """The kernel's path taken for CPU tensors, with the CPU model in the kernel's place."""
    model = _ModelKernel()
    monkeypatch.setattr(ssim_mod, "filter_takes", model.takes)
    monkeypatch.setattr(ssim_mod, "ssim_filter_cuda", model.launch)
    return model


_PLAIN_REL = 1e-6  # float32 sums of the same map in another order


@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
@pytest.mark.parametrize("window,sigma,data_range", [((11, 11), (1.5, 1.5), 1.0), ((7, 11), (1.0, 2.0), None)])
def test_kernel_path_glue_equals_plain(model_kernel, reduction, window, sigma, data_range):
    p, t = _images(5, (3, 2, 70, 45))
    calls = {
        "ssim": lambda: ptf.ssim(p, t, window, sigma, reduction, data_range),
        "uqi": lambda: ptf.universal_image_quality_index(p, t, window, sigma, reduction),
    }
    for name, call in calls.items():
        want = model_kernel.reference(call)
        before = len(model_kernel.calls)
        got = call()
        assert model_kernel.calls[before:] == [reduction == "none"]  # one launch a call, maps only for "none"
        assert got.shape == want.shape
        torch.testing.assert_close(got, want, rtol=_PLAIN_REL, atol=0)


@pytest.mark.parametrize("data_range", [1.0, None])
def test_kernel_path_ms_ssim_per_image_means_equal_plain(model_kernel, data_range):
    p, t = _images(6, (3, 2, 96, 100))

    def call():
        return ptf.multiscale_ssim(p, t, (5, 5), (1.5, 1.5), "none", data_range)

    want = model_kernel.reference(call)
    got = call()
    assert model_kernel.calls == [False] * 5  # one sums launch a scale
    torch.testing.assert_close(got, want, rtol=_PLAIN_REL, atol=0)


@pytest.mark.parametrize("name", ["ssim", "stored", "uqi", "ms_ssim"])
def test_kernel_path_modules_sum_and_count_equal_plain(model_kernel, name):
    make = {
        "ssim": lambda: pt.SSIM(data_range=1.0, device="cpu"),
        "stored": lambda: pt.SSIM(device="cpu"),
        "uqi": lambda: pt.UniversalImageQualityIndex(device="cpu"),
        "ms_ssim": lambda: pt.MultiScaleSSIM(data_range=1.0, kernel_size=(3, 3), betas=(0.5, 0.5), device="cpu"),
    }[name]
    plain, kernel = make(), make()
    for i in range(2):
        p, t = _images(7 + i, (2, 3, 40, 48))
        model_kernel.reference(lambda: plain.update(p, t))
        kernel.update(p, t)
    got = kernel.compute()
    assert model_kernel.calls  # the stored mode launches at compute(), the others at each update
    torch.testing.assert_close(got, model_kernel.reference(plain.compute), rtol=_PLAIN_REL, atol=0)
    count = {"ssim": "total", "uqi": "count", "ms_ssim": "count"}.get(name)
    if count is not None:
        got_count, want_count = getattr(kernel, count), getattr(plain, count)
        assert got_count.dtype == torch.int64 and torch.equal(got_count, want_count)


def test_cpu_tensors_take_the_plain_path_and_move_no_counter():
    launches, plain = ssim_filter_cuda.launches, ssim_filter_cuda.plain_cuda_calls
    p, t = _images(8, (2, 3, 64, 64))
    ptf.ssim(p, t, data_range=1.0)
    ptf.multiscale_ssim(p, t, (3, 3), data_range=1.0, betas=(0.5, 0.5))
    ptf.universal_image_quality_index(p, t)
    assert (ssim_filter_cuda.launches, ssim_filter_cuda.plain_cuda_calls) == (launches, plain)
