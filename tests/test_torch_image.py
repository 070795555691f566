"""Image quality: SSIM, MS-SSIM, UQI, PSNR, total variation, SAM and ERGAS against the JAX package.

The same numpy images (from a seed) go through ``metrics_tpu`` and
``metrics_tpu_torch`` (``device="cpu"``): the functionals, and every module
through a forward / compute / reset cycle. SSIM is also held against a float64
oracle built on ``scipy.ndimage.correlate1d`` with ``mode="mirror"`` (the mode
that, like ``jnp.pad`` / ``F.pad`` ``reflect``, leaves the edge pixel out).

Tolerances: the port filters with K shifted multiply-adds in float32, the JAX
package with XLA's convolution at ``Precision.HIGHEST``, in another order. The
moment maps then cancel (``var = E[x^2] - mu^2``): a pixel's variance of
~0.003 from second moments of ~0.3 keeps about 1e-5 of its value, so a pixel
of an SSIM or UQI map is held to 1e-4 absolute (maps in [-1, 1]), against the
JAX package and against the float64 oracle alike, and a mean over a map to
rtol 1e-5. PSNR, TV, SAM and ERGAS are the same float32 formula over sums of
at most 8,000 terms: rtol 1e-5.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage
import torch
import torch.nn.functional as F

import metrics_tpu as mt
import metrics_tpu.functional as mtf
import metrics_tpu_torch as pt
import metrics_tpu_torch.functional as ptf
from metrics_tpu_torch.functional.regression.ssim import _filter_1d, _gaussian

torch.set_num_threads(1)

_RTOL, _ATOL_MAP = 1e-5, 1e-4
SHAPE = (2, 3, 33, 41)  # odd sides
MS_SHAPE = (2, 3, 49, 52)  # five scales at kernel 3; 49 drops its odd row at the first pool


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def _images(seed, shape=SHAPE, noise=0.05):
    """A smooth target in [0, 1] and a noisy prediction clipped to [0, 1]."""
    rng = np.random.RandomState(seed)
    n, c, h, w = shape
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w), indexing="ij")
    phase = rng.rand(n, c, 1, 1) * 6
    target = 0.5 + 0.25 * np.sin(6 * yy + phase) * np.cos(5 * xx - phase) + 0.1 * rng.rand(n, c, h, w)
    preds = np.clip(target + noise * rng.randn(*shape), 0, 1)
    return preds.astype(np.float32), np.clip(target, 0, 1).astype(np.float32)


def _np(x):
    return x.detach().to(torch.float64).numpy() if isinstance(x, torch.Tensor) else np.asarray(x, dtype=np.float64)


def _close(got, want, rtol=_RTOL, atol=0.0, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol, err_msg=what)


# ------------------------------------------------------------------ functionals
_SSIM_CASES = [
    ((11, 11), (1.5, 1.5), 1.0, "elementwise_mean"),
    ((7, 11), (1.0, 2.0), None, "none"),
    ((3, 5), (0.5, 1.0), 1.0, "sum"),
]


@pytest.mark.parametrize("kernel_size,sigma,data_range,reduction", _SSIM_CASES)
def test_ssim_and_uqi_match_jax(kernel_size, sigma, data_range, reduction):
    p, t = _images(1)
    kw = dict(kernel_size=kernel_size, sigma=sigma, reduction=reduction)
    want = mtf.ssim(jnp.asarray(p), jnp.asarray(t), data_range=data_range, **kw)
    got = ptf.ssim(torch.from_numpy(p), torch.from_numpy(t), data_range=data_range, **kw)
    if reduction == "none":
        assert got.shape == (2, 3, 33 - kernel_size[0] + 1, 41 - kernel_size[1] + 1)  # the border ring cropped
        _close(got, want, rtol=0, atol=_ATOL_MAP, what="ssim map")
    else:
        _close(got, want, what="ssim")
    want = mtf.universal_image_quality_index(jnp.asarray(p), jnp.asarray(t), **kw)
    got = ptf.universal_image_quality_index(torch.from_numpy(p), torch.from_numpy(t), **kw)
    _close(got, want, rtol=_RTOL if reduction != "none" else 0, atol=0 if reduction != "none" else _ATOL_MAP,
           what="uqi")


def test_uqi_flat_windows_match_jax():
    """Flat windows: an all-black prediction of an all-white target scores 0, equal flat images 1."""
    ones, zeros = np.ones((1, 1, 16, 16), np.float32), np.zeros((1, 1, 16, 16), np.float32)
    for p, t in ((zeros, ones), (ones, ones), (zeros, zeros), (0.5 * ones, ones)):
        want = mtf.universal_image_quality_index(jnp.asarray(p), jnp.asarray(t), kernel_size=(5, 5))
        got = ptf.universal_image_quality_index(torch.from_numpy(p), torch.from_numpy(t), kernel_size=(5, 5))
        _close(got, want, atol=1e-6)  # 0 and 1 up to float32 rounding of the shifted means


@pytest.mark.parametrize("kernel_size,betas,shape", [
    ((3, 3), (0.0448, 0.2856, 0.3001, 0.2363, 0.1333), MS_SHAPE),
    ((3, 5), (0.5, 0.3, 0.2), (1, 2, 23, 27)),
])
def test_multiscale_ssim_matches_jax(kernel_size, betas, shape):
    p, t = _images(2, shape)
    for data_range in (1.0, None):
        kw = dict(kernel_size=kernel_size, betas=betas, data_range=data_range, reduction="none")
        want = mtf.multiscale_ssim(jnp.asarray(p), jnp.asarray(t), **kw)
        got = ptf.multiscale_ssim(torch.from_numpy(p), torch.from_numpy(t), **kw)
        assert got.shape == (shape[0],)
        _close(got, want, what=f"ms-ssim data_range={data_range}")


@pytest.mark.parametrize("shape,kernel_size,betas", [((1, 1, 40, 40), (11, 11), 5), ((1, 1, 90, 31), (3, 5), 4)])
def test_multiscale_ssim_too_small_message_equals_jax(shape, kernel_size, betas):
    x = np.zeros(shape, np.float32)
    b = (0.2,) * betas
    with pytest.raises(ValueError) as want:
        mtf.multiscale_ssim(jnp.asarray(x), jnp.asarray(x), kernel_size=kernel_size, betas=b)
    with pytest.raises(ValueError) as got:
        ptf.multiscale_ssim(torch.from_numpy(x), torch.from_numpy(x), kernel_size=kernel_size, betas=b)
    assert str(got.value) == str(want.value) and "too small" in str(got.value)


_SSIM_ERRORS = [
    ("ssim", (np.zeros((1, 1, 8, 8), np.float32), np.zeros((1, 1, 8, 8), np.float16)), {}),
    ("ssim", (np.zeros((1, 8, 8), np.float32), np.zeros((1, 8, 8), np.float32)), {}),
    ("ssim", (np.zeros((1, 1, 8, 8), np.float32),) * 2, {"kernel_size": (4, 5)}),
    ("ssim", (np.zeros((1, 1, 8, 8), np.float32),) * 2, {"kernel_size": (3,)}),
    ("ssim", (np.zeros((1, 1, 8, 8), np.float32),) * 2, {"sigma": (1.0, 0.0)}),
    ("spectral_angle_mapper", (np.zeros((1, 1, 8, 8), np.float32),) * 2, {}),
    ("error_relative_global_dimensionless_synthesis", (np.zeros((1, 1, 8, 8), np.float32),) * 2, {"ratio": 0}),
    ("total_variation", (np.zeros((1, 8, 8), np.float32),), {}),
    ("total_variation", (np.zeros((1, 1, 8, 8), np.float32),), {"reduction": "max"}),
    ("psnr", (np.zeros((1, 8), np.float32),) * 2, {"dim": 1}),
]


@pytest.mark.parametrize("name,args,kw", _SSIM_ERRORS, ids=[f"{n}-{i}" for i, (n, _, _) in enumerate(_SSIM_ERRORS)])
def test_image_errors_match_jax(name, args, kw):
    with pytest.raises(Exception) as want:
        getattr(mtf, name)(*(jnp.asarray(a) for a in args), **kw)
    with pytest.raises(want.type) as got:
        getattr(ptf, name)(*(torch.from_numpy(a) for a in args), **kw)
    assert str(got.value) == str(want.value)


_PSNR_CASES = [
    {}, {"data_range": 1.0}, {"data_range": 2.0, "base": 2.0},
    {"data_range": 1.0, "dim": 1, "reduction": "none"}, {"data_range": 1.0, "dim": (1, 2), "reduction": "sum"},
    {"data_range": 1.0, "dim": (2, 3)},
]


@pytest.mark.parametrize("kw", _PSNR_CASES, ids=[str(sorted(k.items())) for k in _PSNR_CASES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_psnr_matches_jax(kw, dtype):
    p, t = _images(3)
    jp, jt = jnp.asarray(p).astype(dtype), jnp.asarray(t).astype(dtype)
    tp, tt = (torch.from_numpy(x).to(getattr(torch, dtype)) for x in (p, t))
    _close(ptf.psnr(tp, tt, **kw), mtf.psnr(jp, jt, **kw), what=str(kw))


@pytest.mark.parametrize("name,kw", [
    ("total_variation", {}), ("total_variation", {"reduction": "mean"}),
    ("spectral_angle_mapper", {}), ("spectral_angle_mapper", {"reduction": "none"}),
    ("error_relative_global_dimensionless_synthesis", {}),
    ("error_relative_global_dimensionless_synthesis", {"ratio": 2.0, "reduction": "sum"}),
])
def test_tv_sam_ergas_match_jax(name, kw):
    p, t = _images(4)
    p[0, :, :4, :4] = 0  # pixels whose spectrum is zero in one image
    t[0, :, :2, :2] = 0  # and in both
    args = (p,) if name == "total_variation" else (p, t)
    want = getattr(mtf, name)(*(jnp.asarray(a) for a in args), **kw)
    got = getattr(ptf, name)(*(torch.from_numpy(a) for a in args), **kw)
    _close(got, want, what=name)


def _ssim_oracle(p, t, kernel_size=(11, 11), sigma=(1.5, 1.5), data_range=1.0, k1=0.01, k2=0.03):
    """Float64 SSIM maps from ``scipy.ndimage.correlate1d`` (``mode="mirror"``), border cropped."""
    p, t = p.astype(np.float64), t.astype(np.float64)

    def window(k, s):
        x = np.arange(k) - (k - 1) / 2
        g = np.exp(-((x / s) ** 2) / 2)
        return g / g.sum()

    def blur(x):
        x = scipy.ndimage.correlate1d(x, window(kernel_size[0], sigma[0]), axis=-2, mode="mirror")
        return scipy.ndimage.correlate1d(x, window(kernel_size[1], sigma[1]), axis=-1, mode="mirror")

    mu_p, mu_t = blur(p), blur(t)
    var_p, var_t, cov = blur(p * p) - mu_p**2, blur(t * t) - mu_t**2, blur(p * t) - mu_p * mu_t
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    ssim_map = (2 * mu_p * mu_t + c1) * (2 * cov + c2) / ((mu_p**2 + mu_t**2 + c1) * (var_p + var_t + c2))
    ph, pw = (kernel_size[0] - 1) // 2, (kernel_size[1] - 1) // 2
    return ssim_map[..., ph:ssim_map.shape[-2] - ph, pw:ssim_map.shape[-1] - pw]


@pytest.mark.parametrize("kernel_size,sigma", [((11, 11), (1.5, 1.5)), ((7, 11), (1.0, 2.0))])
def test_ssim_equals_a_float64_scipy_oracle(kernel_size, sigma):
    p, t = _images(5)
    got = ptf.ssim(torch.from_numpy(p), torch.from_numpy(t), kernel_size=kernel_size, sigma=sigma, data_range=1.0,
                   reduction="none")
    oracle = _ssim_oracle(p, t, kernel_size, sigma)
    np.testing.assert_allclose(_np(got), oracle, rtol=0, atol=_ATOL_MAP)
    np.testing.assert_allclose(_np(got).mean(), oracle.mean(), rtol=_RTOL)


def test_filter_is_the_separable_depthwise_convolution():
    """In float64, the K multiply-adds equal ``F.conv2d`` with the same window (groups = C)."""
    x = torch.from_numpy(np.random.RandomState(6).rand(2, 3, 19, 23))
    wh, ww = _gaussian(7, 1.0, torch.float64), _gaussian(11, 2.0, torch.float64)
    got = _filter_1d(_filter_1d(x, wh, 2), ww, 3)
    want = F.conv2d(F.conv2d(x, wh.view(1, 1, -1, 1).repeat(3, 1, 1, 1), groups=3),
                    ww.view(1, 1, 1, -1).repeat(3, 1, 1, 1), groups=3)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-14)


# ---------------------------------------------------------------------- modules
_MODULES = [
    ("SSIM", {"data_range": 1.0}, SHAPE),
    ("SSIM", {"data_range": 1.0, "kernel_size": (7, 11), "sigma": (1.0, 2.0), "reduction": "sum"}, SHAPE),
    ("SSIM", {}, SHAPE),
    ("SSIM", {"data_range": 1.0, "capacity": 8, "image_shape": (3, 33, 41)}, SHAPE),
    ("MultiScaleSSIM", {"data_range": 1.0, "kernel_size": (3, 3)}, MS_SHAPE),
    ("PSNR", {}, SHAPE),
    ("PSNR", {"data_range": 1.0}, SHAPE),
    ("PSNR", {"data_range": 1.0, "dim": (1, 2, 3), "reduction": "none"}, SHAPE),
    ("UniversalImageQualityIndex", {"kernel_size": (7, 11), "sigma": (1.0, 2.0)}, SHAPE),
    ("TotalVariation", {}, SHAPE),
    ("TotalVariation", {"reduction": "mean"}, SHAPE),
    ("SpectralAngleMapper", {}, SHAPE),
    ("ErrorRelativeGlobalDimensionlessSynthesis", {"ratio": 2.0}, SHAPE),
]


@pytest.mark.parametrize("name,kw,shape", _MODULES, ids=[f"{n}-{sorted(k.items())}" for n, k, _ in _MODULES])
def test_module_forward_compute_reset_matches_jax(name, kw, shape):
    jm, tm = getattr(mt, name)(**kw), getattr(pt, name)(device="cpu", **kw)
    if name == "SSIM":
        assert tm.streaming == jm.streaming == ("data_range" in kw and "capacity" not in kw)
    for step in range(3):
        p, t = _images(10 + step, shape)
        args = (p,) if name == "TotalVariation" else (p, t)
        want = jm(*(jnp.asarray(a) for a in args))
        got = tm(*(torch.from_numpy(a) for a in args))
        _close(got, want, what=f"{name} step {step}")
    _close(tm.compute(), jm.compute(), what=f"{name} epoch")
    for state, value in tm._current_state().items():
        values = getattr(value, "data", value)
        for v in values if isinstance(values, list) else [values]:
            assert v.dtype in (torch.float32, torch.int64), (state, v.dtype)  # float32, never float64
        if isinstance(value, torch.Tensor) and not value.is_floating_point():
            assert int(value) == int(getattr(jm, state)), state
    tm.reset()
    jm.reset()
    p, t = _images(20, shape)
    args = (p,) if name == "TotalVariation" else (p, t)
    jm(*(jnp.asarray(a) for a in args))
    tm(*(torch.from_numpy(a) for a in args))
    _close(tm.compute(), jm.compute(), what=f"{name} after reset")


def test_image_collection_takes_keywords_that_each_member_filters():
    """``TotalVariation`` reads ``img=``: the collection is called with keywords, and every member,
    ``SumCountMetric`` ones too (filtered by ``_update_stats``), takes only its own."""
    kw = dict(device="cpu")
    col = pt.MetricCollection([pt.SSIM(data_range=1.0, **kw), pt.TotalVariation(**kw), pt.SpectralAngleMapper(**kw),
                               pt.ErrorRelativeGlobalDimensionlessSynthesis(**kw), pt.PSNR(data_range=1.0, **kw)])
    alone = {name: getattr(pt, name)(**({"data_range": 1.0} if name in ("SSIM", "PSNR") else {}), **kw)
             for name in col}
    for seed in (30, 31):
        p, t = (torch.from_numpy(x) for x in _images(seed))
        got = col(preds=p, target=t, img=p)
        for name, m in alone.items():
            want = m(p) if name == "TotalVariation" else m(p, t)
            assert torch.equal(got[name], want), name
    assert all(torch.equal(v, alone[k].compute()) for k, v in col.compute().items())
