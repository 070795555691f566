"""Classification functionals and modules: the port against the JAX package.

The same numpy inputs (from a seed) go through ``metrics_tpu`` and
``metrics_tpu_torch`` (``device="cpu"``). Counts (stat scores, module count
states) must be equal; float results agree to rtol 1e-6, since both compute
the same float32 formulas and differ at most in the order of a mean.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt
import metrics_tpu.functional as mtf
import metrics_tpu_torch as pt
from metrics_tpu_torch.functional.classification import accuracy, f1, fbeta, precision, recall, stat_scores

torch.set_num_threads(1)

N, C, X = 24, 4, 3
_RTOL = 1e-6


def _data(kind, seed):
    rng = np.random.RandomState(seed)
    if kind == "binary":
        return rng.rand(N).astype(np.float32), rng.randint(0, 2, N)
    if kind == "mc_probs":
        logits = rng.randn(N, C)
        probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        return probs.astype(np.float32), rng.randint(0, C, N)
    if kind == "multilabel":
        return rng.rand(N, C).astype(np.float32), rng.randint(0, 2, (N, C))
    if kind == "mc_labels":
        return rng.randint(0, C, N), rng.randint(0, C, N)
    if kind == "mdmc_probs":
        logits = rng.randn(N, C, X)
        probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        return probs.astype(np.float32), rng.randint(0, C, (N, X))
    raise ValueError(kind)


def _assert_close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=_RTOL, atol=0)


_PRF = [("precision", precision), ("recall", recall), ("f1", f1), ("fbeta", fbeta)]
_PRF_ARGS = [
    ("mc_probs", {"average": "micro"}),
    ("mc_probs", {"average": "macro", "num_classes": C}),
    ("mc_probs", {"average": "weighted", "num_classes": C}),
    ("mc_probs", {"average": "none", "num_classes": C}),
    ("mc_probs", {"average": "macro", "num_classes": C, "top_k": 2}),
    ("multilabel", {"average": "macro", "num_classes": C}),
    ("multilabel", {"average": "samples"}),
    ("binary", {"average": "micro"}),
    ("mc_labels", {"average": "macro", "num_classes": C, "ignore_index": 1}),
    ("mdmc_probs", {"average": "macro", "num_classes": C, "mdmc_average": "global"}),
]

_FUNCTIONAL_CASES = [
    ("accuracy", accuracy, "binary", {}),
    ("accuracy", accuracy, "mc_probs", {}),
    ("accuracy", accuracy, "mc_probs", {"top_k": 2}),
    ("accuracy", accuracy, "multilabel", {}),
    ("accuracy", accuracy, "multilabel", {"subset_accuracy": True}),
    ("accuracy", accuracy, "mc_labels", {}),
    ("accuracy", accuracy, "mdmc_probs", {}),
    ("accuracy", accuracy, "mdmc_probs", {"subset_accuracy": True}),
    ("stat_scores", stat_scores, "mc_probs", {"reduce": "macro", "num_classes": C}),
    ("stat_scores", stat_scores, "binary", {}),
    ("stat_scores", stat_scores, "multilabel", {"reduce": "samples"}),
    ("stat_scores", stat_scores, "mc_labels", {"reduce": "macro", "num_classes": C, "ignore_index": 1}),
    ("stat_scores", stat_scores, "mdmc_probs", {"reduce": "macro", "num_classes": C, "mdmc_reduce": "samplewise"}),
] + [
    (name, fn, kind, dict(kwargs, **({"beta": 0.5} if name == "fbeta" else {})))
    for name, fn in _PRF
    for kind, kwargs in _PRF_ARGS
]


@pytest.mark.parametrize(
    "name,fn,kind,kwargs", _FUNCTIONAL_CASES, ids=[f"{c[0]}-{c[2]}-{i}" for i, c in enumerate(_FUNCTIONAL_CASES)]
)
def test_functional_matches_jax(name, fn, kind, kwargs):
    preds, target = _data(kind, seed=len(name) + len(kwargs))
    want = getattr(mtf, name)(jnp.asarray(preds), jnp.asarray(target), **kwargs)
    got = fn(torch.from_numpy(preds), torch.from_numpy(target), **kwargs)
    _assert_close(got, want)


_MODULE_CASES = [
    ("Accuracy", {}, "mc_probs"),
    ("Accuracy", {"top_k": 2}, "mc_probs"),
    ("Accuracy", {}, "binary"),
    ("Accuracy", {}, "multilabel"),
    ("StatScores", {"reduce": "macro", "num_classes": C}, "mc_probs"),
    ("StatScores", {"reduce": "samples"}, "multilabel"),
    ("Precision", {"num_classes": C, "average": "macro"}, "mc_probs"),
    ("Precision", {}, "binary"),
    ("Recall", {"num_classes": C, "average": "weighted"}, "mc_probs"),
    ("Recall", {"num_classes": C, "average": "macro", "top_k": 2}, "mc_probs"),
    ("F1", {"num_classes": C, "average": "none"}, "mc_probs"),
    ("F1", {"num_classes": C, "average": "macro", "ignore_index": 1}, "mc_labels"),
    ("FBeta", {"num_classes": C, "beta": 0.5, "average": "micro"}, "mc_probs"),
    ("FBeta", {"num_classes": C, "beta": 2.0, "average": "macro"}, "multilabel"),
]


@pytest.mark.parametrize("name,kwargs,kind", _MODULE_CASES, ids=[f"{c[0]}-{c[2]}-{i}" for i, c in enumerate(_MODULE_CASES)])
def test_module_forward_and_accumulation_match_jax(name, kwargs, kind):
    ref = getattr(mt, name)(**kwargs)
    port = getattr(pt, name)(device="cpu", **kwargs)
    for step in range(3):
        preds, target = _data(kind, seed=100 + step)
        want = ref(jnp.asarray(preds), jnp.asarray(target))
        got = port(torch.from_numpy(preds), torch.from_numpy(target))
        _assert_close(got, want)  # the per-step (batch) value
    _assert_close(port.compute(), ref.compute())  # the epoch value
    for state in ref._defaults:
        ref_v, port_v = getattr(ref, state), getattr(port, state)
        if isinstance(ref_v, list):
            assert len(ref_v) == len(port_v)
            for r, p in zip(ref_v, port_v):
                np.testing.assert_array_equal(p.numpy(), np.asarray(r))
        else:
            assert port_v.dtype == torch.int64
            np.testing.assert_array_equal(port_v.numpy(), np.asarray(ref_v))
    port.reset()
    assert port._epoch_watermark == 0
    for state, default in port._defaults.items():
        value = getattr(port, state)
        assert value == [] if isinstance(default, list) else torch.equal(value, default)


def test_update_then_compute_matches_forward_path():
    """``update`` + ``compute`` accumulates exactly what ``forward`` does."""
    a = pt.F1(num_classes=C, average="macro", device="cpu")
    b = pt.F1(num_classes=C, average="macro", device="cpu")
    for step in range(3):
        preds, target = _data("mc_probs", seed=step)
        a(torch.from_numpy(preds), torch.from_numpy(target))
        b.update(torch.from_numpy(preds), torch.from_numpy(target))
    assert torch.equal(a.compute(), b.compute())
    assert a._epoch_watermark == b._epoch_watermark == 3


def test_metric_raises_on_invalid_args_like_jax():
    for kwargs in ({"threshold": 1.5}, {"average": "bogus"}, {"average": "macro"}):
        with pytest.raises(ValueError) as want:
            mt.Precision(**kwargs)
        with pytest.raises(ValueError) as got:
            pt.Precision(device="cpu", **kwargs)
        assert str(got.value) == str(want.value)
