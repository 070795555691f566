"""The rest of classification: the port against the JAX package.

``specificity``, ``hamming_distance``, ``exact_match``, ``critical_success_index``,
``calibration_error``, ``hinge_loss`` (on ``SumCountMetric``) and the ranking trio
(``coverage_error``, ``label_ranking_average_precision``, ``label_ranking_loss``),
their modules, the deprecated ``classification.checks`` shim, and the compute-group
partition and ``state_dict`` keys of a mixed collection. The same numpy inputs (from
a seed) go through ``metrics_tpu`` and ``metrics_tpu_torch`` (``device="cpu"``).

Tolerances: integer counts (stat scores, Hamming, CSI and calibration counts, the
ranking ``total``) must be equal. Every float value is the same float32 formula in
both packages and differs at most by the order of a sum over N <= 64 terms (torch
against XLA), a few float32 ulps: rtol 1e-6. The per-bin calibration sums and the
hinge / ranking totals are such sums; CSI, ExactMatch and Hamming divide integers.
"""
import importlib
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt
import metrics_tpu.functional as mtf
import metrics_tpu_torch as pt
import metrics_tpu_torch.functional as ptf
from metrics_tpu.utils.checks import _input_format_classification_one_hot as jax_one_hot
from metrics_tpu_torch.utils.checks import _input_format_classification_one_hot

torch.set_num_threads(1)

N, C, X, L = 32, 4, 3, 6
_RTOL = 1e-6


def _softmax(logits, axis=1):
    e = np.exp(logits - logits.max(axis=axis, keepdims=True))
    return (e / e.sum(axis=axis, keepdims=True)).astype(np.float32)


def _data(kind, seed):
    rng = np.random.RandomState(seed)
    if kind == "binary":
        return rng.rand(N).astype(np.float32), rng.randint(0, 2, N)
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
        p, t = rng.randint(0, C, (N, X)), rng.randint(0, C, (N, X))
        t[: N // 2] = p[: N // 2]  # some exact rows
        return p, t
    if kind == "decisions":  # hinge: binary decision values, {0, 1} targets
        return rng.randn(N).astype(np.float32), rng.randint(0, 2, N)
    if kind == "decisions_pm1":  # hinge: sklearn's {-1, +1} targets
        return rng.randn(N).astype(np.float32), 2 * rng.randint(0, 2, N) - 1
    if kind == "scores":  # hinge: multiclass scores
        return rng.randn(N, C).astype(np.float32), rng.randint(0, C, N)
    if kind == "ranking":  # scores on a 1/8 grid (tied), one row with no true label, one all true
        t = rng.randint(0, 2, (N, L))
        t[0], t[1] = 0, 1
        return (np.round(rng.rand(N, L) * 8) / 8).astype(np.float32), t
    if kind == "events":  # CSI: float forecasts and observations
        return rng.rand(N).astype(np.float32), rng.rand(N).astype(np.float32)
    raise ValueError(kind)


def _pair(preds, target):
    return (jnp.asarray(preds), jnp.asarray(target)), (torch.from_numpy(np.asarray(preds)), torch.from_numpy(target))


def _assert_close(got, want, rtol=_RTOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0)


_FUNCTIONAL_CASES = [
    ("specificity", "mc_probs", {"average": "micro"}),
    ("specificity", "mc_probs", {"average": "macro", "num_classes": C}),
    ("specificity", "mc_probs", {"average": "weighted", "num_classes": C}),
    ("specificity", "mc_probs", {"average": "none", "num_classes": C}),
    ("specificity", "mc_probs", {"average": "macro", "num_classes": C, "top_k": 2}),
    ("specificity", "multilabel", {"average": "macro", "num_classes": C}),
    ("specificity", "multilabel", {"average": "samples"}),
    ("specificity", "binary", {"average": "micro"}),
    ("specificity", "binary", {"average": "macro", "num_classes": 2, "is_multiclass": True}),
    ("specificity", "mc_labels", {"average": "macro", "num_classes": C, "ignore_index": 1}),
    ("specificity", "mdmc_probs", {"average": "macro", "num_classes": C, "mdmc_average": "global"}),
    ("specificity", "mdmc_probs", {"average": "macro", "num_classes": C, "mdmc_average": "samplewise"}),
    ("hamming_distance", "binary", {}),
    ("hamming_distance", "multilabel", {}),
    ("hamming_distance", "multilabel", {"threshold": 0.3}),
    ("hamming_distance", "multilabel_labels", {}),
    ("hamming_distance", "mc_probs", {}),
    ("hamming_distance", "mc_labels", {}),
    ("hamming_distance", "mdmc_probs", {}),
    ("exact_match", "binary", {}),
    ("exact_match", "multilabel", {}),
    ("exact_match", "multilabel", {"threshold": 0.3}),
    ("exact_match", "mc_probs", {}),
    ("exact_match", "mdmc_labels", {"num_classes": C}),
    ("exact_match", "mdmc_probs", {"num_classes": C}),
    ("critical_success_index", "events", {"threshold": 0.5}),
    ("critical_success_index", "events", {"threshold": 0.8}),
    ("critical_success_index", "multilabel", {"threshold": 0.5}),
    ("calibration_error", "mc_probs", {"n_bins": 10}),
    ("calibration_error", "mc_probs", {"n_bins": 15, "norm": "l2"}),
    ("calibration_error", "mc_probs", {"n_bins": 5, "norm": "max"}),
    ("calibration_error", "binary", {"n_bins": 10}),
    ("calibration_error", "binary", {"n_bins": 7, "norm": "max"}),
    ("hinge_loss", "decisions", {}),
    ("hinge_loss", "decisions", {"squared": True}),
    ("hinge_loss", "decisions_pm1", {}),
    ("hinge_loss", "scores", {}),
    ("hinge_loss", "scores", {"squared": True}),
    ("coverage_error", "ranking", {}),
    ("label_ranking_average_precision", "ranking", {}),
    ("label_ranking_loss", "ranking", {}),
]


@pytest.mark.parametrize(
    "name,kind,kwargs", _FUNCTIONAL_CASES, ids=[f"{c[0]}-{c[1]}-{i}" for i, c in enumerate(_FUNCTIONAL_CASES)]
)
def test_functional_matches_jax(name, kind, kwargs):
    (jp, jt), (tp, tt) = _pair(*_data(kind, seed=len(name) + len(kwargs)))
    _assert_close(getattr(ptf, name)(tp, tt, **kwargs), getattr(mtf, name)(jp, jt, **kwargs))


@pytest.mark.parametrize(
    "name,preds,target",
    [
        ("coverage_error", [[0.5, 0.5, 0.3, 0.3]], [[1, 0, 1, 0]]),  # ties across (true, false) pairs
        ("label_ranking_average_precision", [[0.5, 0.5, 0.3, 0.3]], [[1, 0, 1, 0]]),
        ("label_ranking_loss", [[0.5, 0.5, 0.3, 0.3]], [[1, 0, 1, 0]]),
        ("coverage_error", [[0.1, 0.9], [0.4, 0.2]], [[0, 0], [0, 0]]),  # degenerate rows
        ("label_ranking_average_precision", [[0.1, 0.9], [0.4, 0.2]], [[0, 0], [0, 0]]),
        ("label_ranking_average_precision", [[0.1, 0.9], [0.4, 0.2]], [[1, 1], [1, 1]]),
        ("label_ranking_loss", [[0.1, 0.9], [0.4, 0.2]], [[0, 0], [0, 0]]),
        ("label_ranking_loss", [[0.1, 0.9], [0.4, 0.2]], [[1, 1], [1, 1]]),
        ("critical_success_index", [0.9, 0.4, 0.8, 0.1], [1.0, 0.0, 0.0, 1.0]),
        ("critical_success_index", [0.1, 0.2], [0.0, 0.3]),  # no event predicted or observed: nan
        ("hinge_loss", [0.5, -0.2, 0.3, 2.0], [-1, -1, 1, 1]),
    ],
)
def test_edge_cases_match_jax(name, preds, target):
    preds, target = np.asarray(preds, dtype=np.float32), np.asarray(target)
    kw = {"threshold": 0.5} if name == "critical_success_index" else {}
    (jp, jt), (tp, tt) = _pair(preds, target)
    want = getattr(mtf, name)(jp, jt, **kw)
    got = getattr(ptf, name)(tp, tt, **kw)
    if np.isnan(np.asarray(want)):
        assert torch.isnan(got)
    else:
        _assert_close(got, want)


def _build(pkg, name, kwargs):
    return getattr(pkg, name)(**kwargs, **({"device": "cpu"} if pkg is pt else {}))


_MODULE_CASES = [
    ("Specificity", {"num_classes": C, "average": "macro"}, "mc_probs"),
    ("Specificity", {"num_classes": C, "average": "weighted"}, "mc_labels"),
    ("Specificity", {"average": "samples"}, "multilabel"),
    ("Specificity", {"num_classes": C, "average": "macro", "mdmc_average": "samplewise"}, "mdmc_probs"),
    ("HammingDistance", {}, "multilabel"),
    ("HammingDistance", {}, "mc_probs"),
    ("ExactMatch", {}, "multilabel"),
    ("ExactMatch", {"num_classes": C}, "mdmc_labels"),
    ("CriticalSuccessIndex", {"threshold": 0.6}, "events"),
    ("CalibrationError", {"n_bins": 10}, "mc_probs"),
    ("CalibrationError", {"norm": "max"}, "binary"),
    ("HingeLoss", {}, "decisions_pm1"),
    ("HingeLoss", {"squared": True}, "scores"),
    ("CoverageError", {}, "ranking"),
    ("LabelRankingAveragePrecision", {}, "ranking"),
    ("LabelRankingLoss", {}, "ranking"),
]


@pytest.mark.parametrize(
    "name,kwargs,kind", _MODULE_CASES, ids=[f"{c[0]}-{c[2]}-{i}" for i, c in enumerate(_MODULE_CASES)]
)
def test_module_forward_and_epoch_match_jax(name, kwargs, kind):
    ref, port = _build(mt, name, kwargs), _build(pt, name, kwargs)
    for step in range(3):
        (jp, jt), (tp, tt) = _pair(*_data(kind, seed=100 + step))
        _assert_close(port(tp, tt), ref(jp, jt))  # the batch value
    _assert_close(port.compute(), ref.compute())  # the epoch value
    for state in ref._defaults:
        ref_v, port_v = getattr(ref, state), getattr(port, state)
        if isinstance(ref_v, list):
            assert len(ref_v) == len(port_v)
            for r, p in zip(ref_v, port_v):
                np.testing.assert_array_equal(p.numpy(), np.asarray(r))
        elif np.issubdtype(np.asarray(ref_v).dtype, np.integer):
            assert port_v.dtype == torch.int64
            np.testing.assert_array_equal(port_v.numpy(), np.asarray(ref_v))
        else:
            assert port_v.dtype == torch.float32
            np.testing.assert_allclose(port_v.numpy(), np.asarray(ref_v), rtol=_RTOL, atol=0)
    port.reset()
    for state, default in port._defaults.items():
        value = getattr(port, state)
        assert value == [] if isinstance(default, list) else torch.equal(value, default)


def test_empty_modules_match_jax():
    """No update: ExactMatch and CSI give nan, the sum/count metrics 0 (count clamped to 1)."""
    for name in ("ExactMatch", "CriticalSuccessIndex", "HingeLoss", "CoverageError", "LabelRankingLoss"):
        want, got = np.asarray(_build(mt, name, {}).compute()), _build(pt, name, {}).compute()
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


_MODULE_ERRORS = [
    ("Specificity", {"average": "bogus"}),
    ("Specificity", {"average": "macro"}),
    ("HammingDistance", {"threshold": 1.5}),
    ("CalibrationError", {"norm": "bogus"}),
    ("CalibrationError", {"n_bins": 0}),
]


@pytest.mark.parametrize("name,kwargs", _MODULE_ERRORS, ids=[f"{c[0]}-{i}" for i, c in enumerate(_MODULE_ERRORS)])
def test_module_errors_match_jax(name, kwargs):
    with pytest.raises(ValueError) as want:
        _build(mt, name, kwargs)
    with pytest.raises(ValueError) as got:
        _build(pt, name, kwargs)
    assert str(got.value) == str(want.value)


_F32, _I64 = np.float32, np.int64
_FUNCTIONAL_ERRORS = [
    ("specificity", np.full((4, 2), 0.5, _F32), np.zeros(4, _I64), {"average": "macro"}),
    ("calibration_error", np.zeros((4, 2), _F32), np.zeros(4, _I64), {"norm": "huber"}),
    ("calibration_error", np.zeros((4, 2, 2), _F32), np.zeros(4, _I64), {}),
    ("calibration_error", np.zeros((4, 2), _F32), np.zeros(3, _I64), {}),
    ("hinge_loss", np.zeros((2, 2, 2), _F32), np.zeros(2, _I64), {}),
    ("hinge_loss", np.zeros(4, _F32), np.zeros(3, _I64), {}),
    ("coverage_error", np.zeros((4, 3), _F32), np.zeros((4, 2), _I64), {}),
    ("label_ranking_loss", np.zeros(4, _F32), np.zeros(4, _I64), {}),
    ("exact_match", np.full(1, 0.5, _F32), np.full(1, 0.5, _F32), {}),
]


@pytest.mark.parametrize(
    "name,preds,target,kwargs", _FUNCTIONAL_ERRORS, ids=[f"{c[0]}-{i}" for i, c in enumerate(_FUNCTIONAL_ERRORS)]
)
def test_functional_errors_match_jax(name, preds, target, kwargs):
    (jp, jt), (tp, tt) = _pair(preds, target)
    with pytest.raises(ValueError) as want:
        getattr(mtf, name)(jp, jt, **kwargs)
    with pytest.raises(ValueError) as got:
        getattr(ptf, name)(tp, tt, **kwargs)
    assert str(got.value) == str(want.value)


def test_csi_shape_error_matches_jax():
    with pytest.raises(RuntimeError) as want:
        mtf.critical_success_index(jnp.zeros(3), jnp.zeros(4), 0.5)
    with pytest.raises(RuntimeError) as got:
        ptf.critical_success_index(torch.zeros(3), torch.zeros(4), 0.5)
    assert str(got.value) == str(want.value)


def test_checks_shim_warns_and_reexports():
    sys.modules.pop("metrics_tpu_torch.classification.checks", None)
    with pytest.warns(DeprecationWarning, match="metrics_tpu_torch.utils.checks"):
        shim = importlib.import_module("metrics_tpu_torch.classification.checks")
    from metrics_tpu_torch.utils import checks

    for name in ("_check_classification_inputs", "_input_format_classification"):
        assert getattr(shim, name) is getattr(checks, name)
    assert shim._input_format_classification_one_hot is _input_format_classification_one_hot


@pytest.mark.parametrize("kind,multilabel", [("mc_probs", False), ("mc_labels", False), ("multilabel", True),
                                              ("mdmc_probs", False)])
def test_one_hot_formatter_matches_jax(kind, multilabel):
    (jp, jt), (tp, tt) = _pair(*_data(kind, seed=9))
    want = jax_one_hot(C, jp, jt, multilabel=multilabel)
    got = _input_format_classification_one_hot(C, tp, tt, multilabel=multilabel)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def _mixed(pkg):
    kw = {"device": "cpu"} if pkg is pt else {}
    return pkg.MetricCollection({
        "cm": pkg.ConfusionMatrix(num_classes=C, **kw),
        "cm_true": pkg.ConfusionMatrix(num_classes=C, normalize="true", **kw),
        "iou": pkg.IoU(num_classes=C, **kw),
        "kappa": pkg.CohenKappa(num_classes=C, **kw),
        "mcc": pkg.MatthewsCorrcoef(num_classes=C, **kw),
        "spec": pkg.Specificity(num_classes=C, average="macro", **kw),
        "f1": pkg.F1(num_classes=C, average="macro", **kw),
        "prec": pkg.Precision(num_classes=C, average="macro", **kw),
        "spec_micro": pkg.Specificity(**kw),
        "hamming": pkg.HammingDistance(**kw),
        "hamming_b": pkg.HammingDistance(**kw),
        "exact": pkg.ExactMatch(**kw),
        "calib": pkg.CalibrationError(n_bins=5, **kw),
        "hinge": pkg.HingeLoss(**kw),
    })


def test_mixed_collection_groups_and_state_dict_match_jax():
    ref, port = _mixed(mt), _mixed(pt)
    assert port.compute_groups == ref.compute_groups
    assert port.compute_groups["cm"] == ("cm", "cm_true", "iou")
    assert port.compute_groups["spec"] == ("spec", "f1", "prec")
    ref.persistent(True)
    port.persistent(True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for step in range(2):
            (jp, jt), (tp, tt) = _pair(*_data("mc_probs", seed=40 + step))
            got, want = port(tp, tt), ref(jp, jt)
            for k in want:
                _assert_close(got[k], want[k])
        got, want = port.compute(), ref.compute()
    for k in want:
        _assert_close(got[k], want[k])
    ref_sd, port_sd = ref.state_dict(), port.state_dict()
    assert sorted(port_sd) == sorted(ref_sd)
    assert port_sd["_compute_group_manifest"] == ref_sd["_compute_group_manifest"]
    ranking = [pkg.MetricCollection([pkg.CoverageError(**kw), pkg.LabelRankingAveragePrecision(**kw),
                                     pkg.LabelRankingLoss(**kw), pkg.CriticalSuccessIndex(**kw)])
               for pkg, kw in ((mt, {}), (pt, {"device": "cpu"}))]
    assert ranking[1].compute_groups == ranking[0].compute_groups
    assert all(len(members) == 1 for members in ranking[1].compute_groups.values())
