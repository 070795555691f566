"""The confusion-matrix family: the port against the JAX package.

``confusion_matrix``, ``iou``, ``cohen_kappa`` and ``matthews_corrcoef``, their
modules (``ConfusionMatrix``, ``IoU`` / ``JaccardIndex``, ``CohenKappa``,
``MatthewsCorrcoef``) and every ``normalize`` / ``weights`` / ``reduction``
option. The same numpy inputs (from a seed) go through ``metrics_tpu`` and
``metrics_tpu_torch`` (``device="cpu"``).

Tolerances: confusion matrices (and the module count states) must be equal.
A normalized matrix, IoU and MCC are the same float32 formula on the same
integer counts, so they agree to rtol 1e-6. Kappa is ``1 - k`` with ``k`` a
ratio of two float32 sums of C*C products taken in another order (XLA
against torch); for weak agreement ``k`` is near 1, so kappa carries a few
ulps of 1.0 (1.2e-7 each; 2.4e-7 seen over 360 seeded cases) whatever its
size: rtol 1e-6 plus atol 1e-6.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt
import metrics_tpu.functional as mtf
import metrics_tpu_torch as pt
import metrics_tpu_torch.functional as ptf

torch.set_num_threads(1)

N, C, X = 32, 5, 3
_RTOL = 1e-6
_KAPPA_ATOL = 1e-6


def _softmax(logits):
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    return (e / e.sum(axis=1, keepdims=True)).astype(np.float32)


def _data(kind, seed):
    rng = np.random.RandomState(seed)
    if kind == "binary":
        return rng.rand(N).astype(np.float32), rng.randint(0, 2, N)
    if kind == "binary_labels":
        return rng.randint(0, 2, N), rng.randint(0, 2, N)
    if kind == "multilabel":
        return rng.rand(N, C).astype(np.float32), rng.randint(0, 2, (N, C))
    if kind == "multilabel_labels":
        return rng.randint(0, 2, (N, C)), rng.randint(0, 2, (N, C))
    if kind == "mc_probs":
        return _softmax(rng.randn(N, C)), rng.randint(0, C, N)
    if kind == "mc_labels":
        return rng.randint(0, C, N), rng.randint(0, C, N)
    if kind == "mdmc_probs":
        return _softmax(rng.randn(N, C, X)), rng.randint(0, C, (N, X))
    if kind == "mdmc_labels":
        return rng.randint(0, C, (N, X)), rng.randint(0, C, (N, X))
    if kind == "mc_labels_wide":  # labels up to C + 1: those >= num_classes=C drop out
        return rng.randint(0, C + 2, N), rng.randint(0, C + 2, N)
    if kind == "mc_labels_narrow":  # labels below C - 2: the matrix pads to num_classes=C
        return rng.randint(0, C - 2, N), rng.randint(0, C - 2, N)
    raise ValueError(kind)


_CLASSES = {"binary": 2, "binary_labels": 2, "multilabel": 2, "multilabel_labels": 2}
_KINDS = ["binary", "binary_labels", "multilabel", "multilabel_labels", "mc_probs", "mc_labels", "mdmc_probs",
          "mdmc_labels", "mc_labels_wide", "mc_labels_narrow"]


def _num_classes(kind):
    return _CLASSES.get(kind, C)


def _pair(preds, target):
    return (jnp.asarray(preds), jnp.asarray(target)), (torch.from_numpy(np.asarray(preds)), torch.from_numpy(target))


def _assert_close(got, want, rtol=_RTOL, atol=0.0):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("normalize", [None, "none", "true", "pred", "all"])
@pytest.mark.parametrize("kind", _KINDS)
def test_confusion_matrix_matches_jax(kind, normalize):
    (jp, jt), (tp, tt) = _pair(*_data(kind, seed=len(kind)))
    nc = _num_classes(kind)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the NaN warning is held in its own test
        want = mtf.confusion_matrix(jp, jt, num_classes=nc, normalize=normalize)
        got = ptf.confusion_matrix(tp, tt, num_classes=nc, normalize=normalize)
    _assert_close(got, want)
    if normalize in (None, "none"):  # float32 counts of whole pairs
        assert got.sum() > 0 and torch.equal(got, got.round())


def test_confusion_matrix_drops_out_of_range_labels_like_an_oracle():
    preds, target = _data("mc_labels_wide", seed=3)
    keep = (preds < C) & (target < C)
    oracle = np.bincount(target[keep] * C + preds[keep], minlength=C * C).reshape(C, C)
    got = ptf.confusion_matrix(torch.from_numpy(preds), torch.from_numpy(target), num_classes=C)
    np.testing.assert_array_equal(got.numpy(), oracle.astype(np.float32))


def test_confusion_matrix_nan_warning_matches_jax():
    (jp, jt), (tp, tt) = _pair(np.array([0, 0, 1]), np.array([0, 0, 1]))
    with pytest.warns(UserWarning) as want:
        mtf.confusion_matrix(jp, jt, num_classes=3, normalize="true")
    with pytest.warns(UserWarning) as got:
        value = ptf.confusion_matrix(tp, tt, num_classes=3, normalize="true")
    assert [str(w.message) for w in got] == [str(w.message) for w in want]
    assert "3 nan values" in str(got[0].message) and not torch.isnan(value).any()


@pytest.mark.parametrize(
    "reduction,ignore_index,absent_score",
    [("elementwise_mean", None, 0.0), ("none", None, -1.0), ("sum", 1, 0.0), ("none", 0, -1.0), ("none", 255, 0.0)],
)
@pytest.mark.parametrize("kind", ["binary", "multilabel", "mc_probs", "mc_labels", "mdmc_probs", "mc_labels_narrow"])
def test_iou_matches_jax(kind, reduction, ignore_index, absent_score):
    (jp, jt), (tp, tt) = _pair(*_data(kind, seed=7 + len(kind)))
    kw = dict(num_classes=_num_classes(kind), reduction=reduction, ignore_index=ignore_index, absent_score=absent_score)
    _assert_close(ptf.iou(tp, tt, **kw), mtf.iou(jp, jt, **kw))


@pytest.mark.parametrize(
    "preds,target,ignore_index,num_classes,expected",
    [
        ([0], [0], None, 2, [1.0, -1.0]),
        ([0, 2], [0, 2], None, 3, [1.0, -1.0, 1.0]),
        ([0, 2], [0, 2], 0, 3, [-1.0, 1.0]),
        ([1], [1], 0, 3, [1.0, -1.0]),
        ([0, 1], [0, 1], 0, 3, [1.0, -1.0]),
    ],
)
def test_iou_absent_score_table(preds, target, ignore_index, num_classes, expected):
    (jp, jt), (tp, tt) = _pair(np.array(preds), np.array(target))
    kw = dict(ignore_index=ignore_index, absent_score=-1.0, num_classes=num_classes, reduction="none")
    got = ptf.iou(tp, tt, **kw)
    _assert_close(got, mtf.iou(jp, jt, **kw))
    np.testing.assert_allclose(got.numpy(), expected, atol=1e-6)


@pytest.mark.parametrize("weights", [None, "linear", "quadratic"])
@pytest.mark.parametrize("kind", ["binary", "multilabel", "mc_probs", "mc_labels", "mdmc_probs", "mdmc_labels"])
def test_cohen_kappa_matches_jax(kind, weights):
    (jp, jt), (tp, tt) = _pair(*_data(kind, seed=11 + len(kind)))
    nc = _num_classes(kind)
    want = mtf.cohen_kappa(jp, jt, num_classes=nc, weights=weights)
    _assert_close(ptf.cohen_kappa(tp, tt, num_classes=nc, weights=weights), want, atol=_KAPPA_ATOL)


@pytest.mark.parametrize("kind", ["binary", "binary_labels", "multilabel", "mc_probs", "mc_labels", "mdmc_probs"])
def test_matthews_corrcoef_matches_jax(kind):
    (jp, jt), (tp, tt) = _pair(*_data(kind, seed=13 + len(kind)))
    nc = _num_classes(kind)
    _assert_close(ptf.matthews_corrcoef(tp, tt, num_classes=nc), mtf.matthews_corrcoef(jp, jt, num_classes=nc))


_MODULE_CASES = [
    ("ConfusionMatrix", {"normalize": None}, "mc_probs"),
    ("ConfusionMatrix", {"normalize": "true"}, "mdmc_probs"),
    ("ConfusionMatrix", {"normalize": "pred"}, "multilabel"),
    ("ConfusionMatrix", {"normalize": "all"}, "binary"),
    ("ConfusionMatrix", {}, "mc_labels_wide"),
    ("IoU", {}, "mc_probs"),
    ("IoU", {"ignore_index": 0, "reduction": "none", "absent_score": -1.0}, "mc_labels_narrow"),
    ("JaccardIndex", {"reduction": "sum"}, "multilabel"),
    ("CohenKappa", {}, "mc_probs"),
    ("CohenKappa", {"weights": "quadratic"}, "mc_labels"),
    ("CohenKappa", {"weights": "linear"}, "binary"),
    ("MatthewsCorrcoef", {}, "mc_probs"),
    ("MatthewsCorrcoef", {}, "binary"),
]


@pytest.mark.parametrize(
    "name,kwargs,kind", _MODULE_CASES, ids=[f"{c[0]}-{c[2]}-{i}" for i, c in enumerate(_MODULE_CASES)]
)
def test_module_forward_and_epoch_match_jax(name, kwargs, kind):
    nc = _num_classes(kind)
    ref = getattr(mt, name)(num_classes=nc, **kwargs)
    port = getattr(pt, name)(num_classes=nc, device="cpu", **kwargs)
    atol = _KAPPA_ATOL if name == "CohenKappa" else 0.0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for step in range(3):
            (jp, jt), (tp, tt) = _pair(*_data(kind, seed=100 + step))
            _assert_close(port(tp, tt), ref(jp, jt), atol=atol)  # the batch value
        _assert_close(port.compute(), ref.compute(), atol=atol)  # the epoch value
    assert port.confmat.dtype == torch.int64
    np.testing.assert_array_equal(port.confmat.numpy(), np.asarray(ref.confmat))
    port.reset()
    assert torch.equal(port.confmat, torch.zeros(nc, nc, dtype=torch.int64))


@pytest.mark.parametrize(
    "build",
    [
        lambda pkg, **kw: pkg.ConfusionMatrix(num_classes=3, normalize="bogus", **kw),
        lambda pkg, **kw: pkg.CohenKappa(num_classes=3, weights="cubic", **kw),
    ],
    ids=["confmat-normalize", "kappa-weights"],
)
def test_module_argument_errors_match_jax(build):
    with pytest.raises(ValueError) as want:
        build(mt)
    with pytest.raises(ValueError) as got:
        build(pt, device="cpu")
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize(
    "call",
    [
        lambda m, p, t: m.confusion_matrix(p, t, num_classes=2, normalize="rows"),
        lambda m, p, t: m.cohen_kappa(p, t, num_classes=2, weights="cubic"),
    ],
    ids=["confmat-normalize", "kappa-weights"],
)
def test_functional_errors_match_jax(call):
    (jp, jt), (tp, tt) = _pair(np.array([0, 1, 1]), np.array([0, 1, 0]))
    with pytest.raises(ValueError) as want:
        call(mtf, jp, jt)
    with pytest.raises(ValueError) as got:
        call(ptf, tp, tt)
    assert str(got.value) == str(want.value)
