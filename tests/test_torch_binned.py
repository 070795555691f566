"""Binned curve metrics: the port against the JAX package, binary and per-class.

Counts (the module states) must be equal. Curves are the same float32 ratios
of those counts; AUROC and AP are sums (trapezoid / step) taken in another
order, so they agree to rtol 1e-5.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.classification.binned as jax_binned
import metrics_tpu.functional.classification.binned_curves as jax_fn
import metrics_tpu_torch.classification.binned as port_binned
import metrics_tpu_torch.functional.classification.binned_curves as port_fn

torch.set_num_threads(1)

N, C = 300, 3
_RTOL = 1e-5
_MODULES = ["BinnedAUROC", "BinnedAveragePrecision", "BinnedROC", "BinnedPrecisionRecallCurve"]


def _data(num_classes, seed):
    rng = np.random.RandomState(seed)
    shape = (N,) if num_classes is None else (N, num_classes)
    return rng.rand(*shape).astype(np.float32), rng.randint(0, 2, shape)


def _close(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w)
        return
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=_RTOL, atol=0)


@pytest.mark.parametrize("num_classes", [None, C])
@pytest.mark.parametrize("thresholds", [17, [0.9, 0.1, 0.5, 0.5, 0.3]])
@pytest.mark.parametrize("name", _MODULES)
def test_module_matches_jax(name, thresholds, num_classes):
    ref = getattr(jax_binned, name)(num_classes=num_classes, thresholds=thresholds)
    port = getattr(port_binned, name)(num_classes=num_classes, thresholds=thresholds, device="cpu")
    for step in range(3):
        preds, target = _data(num_classes, seed=step)
        _close(port(torch.from_numpy(preds), torch.from_numpy(target)),
               ref(jnp.asarray(preds), jnp.asarray(target)))
    _close(port.compute(), ref.compute())
    for state in ("tp", "fp", "tn", "fn"):
        np.testing.assert_array_equal(getattr(port, state).numpy(), np.asarray(getattr(ref, state)))


@pytest.mark.parametrize("num_classes", [None, C])
@pytest.mark.parametrize(
    "name", ["binned_auroc", "binned_average_precision", "binned_roc", "binned_precision_recall_curve"]
)
def test_functional_matches_jax(name, num_classes):
    preds, target = _data(num_classes, seed=11)
    _close(getattr(port_fn, name)(torch.from_numpy(preds), torch.from_numpy(target), thresholds=50),
           getattr(jax_fn, name)(jnp.asarray(preds), jnp.asarray(target), thresholds=50))


@pytest.mark.parametrize("num_classes", [None, C])
def test_curve_update_counts_match_jax(num_classes):
    preds, target = _data(num_classes, seed=5)
    thr = np.linspace(0.0, 1.0, 40, dtype=np.float32)
    got = port_fn.binned_stat_curve_update(torch.from_numpy(preds), torch.from_numpy(target), torch.from_numpy(thr))
    want = jax_fn.binned_stat_curve_update(jnp.asarray(preds), jnp.asarray(target), thr)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_thresholds_are_a_registered_tensor_on_the_metric_device():
    m = port_binned.BinnedAUROC(thresholds=[0.2, 0.8], device="cpu")
    assert isinstance(m.thresholds, torch.Tensor) and m.thresholds.device == m.device
    assert "thresholds" in dict(m.named_buffers())
    np.testing.assert_array_equal(m.thresholds.numpy(), np.asarray([0.2, 0.8], np.float32))


def test_shape_errors_match_jax():
    for num_classes, preds in ((C, np.zeros(4, np.float32)), (None, np.zeros((4, 2), np.float32))):
        target = np.zeros(preds.shape, np.int64)
        with pytest.raises(ValueError) as want:
            jax_binned.BinnedROC(num_classes=num_classes).update(jnp.asarray(preds), jnp.asarray(target))
        with pytest.raises(ValueError) as got:
            port_binned.BinnedROC(num_classes=num_classes, device="cpu").update(
                torch.from_numpy(preds), torch.from_numpy(target))
        assert str(got.value) == str(want.value)
