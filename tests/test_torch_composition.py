"""CompositionalMetric: every operator overload of the port against the JAX package.

The cases of ``tests/bases/test_composition.py``, each run through both
packages: a dummy metric returning a fixed value, composed with a constant or
another metric by one operator, must compute the same value (float results
to rtol 1e-6: ``pow`` may go through exp/log). Also the fused composed
``forward`` (one forward per child), cache invalidation, ``update`` / ``reset``
reaching both children, and pickle / clone of a composition, which must
re-wrap ``update`` / ``compute`` on the copy.
"""
import operator
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt
import metrics_tpu_torch as pt
from metrics_tpu.core.metric import CompositionalMetric as JaxCompositional

torch.set_num_threads(1)


def _dummy(pkg, xp, value):
    class Dummy(pkg.Metric):
        def __init__(self):
            kw = {"device": "cpu"} if pkg is pt else {}
            super().__init__(**kw)
            self.add_state("_num_updates", np.zeros((), np.int32), dist_reduce_fx="sum")
            self._val_to_return = value

        def update(self, *args, **kwargs):
            self._num_updates = self._num_updates + 1

        def compute(self):
            return xp.asarray(self._val_to_return)

    return Dummy()


_PKGS = ((pt, torch, torch.as_tensor), (mt, jnp, jnp.asarray))

_BINARY = [
    ("add", operator.add, 2, [2, 2.0, np.asarray(2)]),
    ("sub", operator.sub, 3, [2, 2.0]),
    ("mul", operator.mul, 2, [2, 2.0]),
    ("truediv", operator.truediv, 6, [3, 3.0, np.asarray(3)]),
    ("floordiv", operator.floordiv, 5, [2, 2.0]),
    ("mod", operator.mod, 11, [5, 5.0]),
    ("pow", operator.pow, 3, [2, 2.0]),
    ("and", operator.and_, 2, [np.asarray(6)]),
    ("or", operator.or_, 2, [np.asarray(6)]),
    ("xor", operator.xor, 2, [np.asarray(6)]),
    ("lt", operator.lt, 3, [2]),
    ("le", operator.le, 3, [2]),
    ("gt", operator.gt, 3, [2]),
    ("ge", operator.ge, 3, [2]),
    ("eq", operator.eq, 3, [2, 3]),
    ("ne", operator.ne, 3, [2, 3]),
]


def _operand(spec, conv):
    return conv(spec) if isinstance(spec, np.ndarray) else spec


@pytest.mark.parametrize("reflected", [False, True])
@pytest.mark.parametrize("name,op,value,operands", _BINARY, ids=[c[0] for c in _BINARY])
def test_binary_operator_matches_jax(name, op, value, operands, reflected):
    for spec in operands:
        if reflected and name in ("lt", "le", "gt", "ge", "eq", "ne"):
            continue  # a reflected comparison is the mirrored operator on the metric
        got = []
        for pkg, xp, conv in _PKGS:
            m = _dummy(pkg, xp, value)
            other = _operand(spec, conv)
            composed = op(other, m) if reflected else op(m, other)
            assert isinstance(composed, pt.CompositionalMetric if pkg is pt else JaxCompositional)
            composed.update()
            got.append(np.asarray(composed.compute()))
        np.testing.assert_allclose(got[0].astype(np.float64), got[1].astype(np.float64), rtol=1e-6, err_msg=f"{name} {spec}")


def test_matmul_matches_jax():
    got = []
    for pkg, xp, conv in _PKGS:
        composed = _dummy(pkg, xp, [2, 2, 2]) @ conv(np.asarray([2, 2, 2]))
        composed.update()
        got.append(float(composed.compute()))
    assert got == [12.0, 12.0]


@pytest.mark.parametrize("name,fn,value", [
    ("abs", abs, -2), ("neg", operator.neg, -2), ("neg_positive", operator.neg, 2), ("pos", operator.pos, -2),
    ("invert", operator.invert, 1),
])
def test_unary_operator_matches_jax(name, fn, value):
    got = [float(np.asarray(fn(_dummy(pkg, xp, value)).compute())) for pkg, xp, _ in _PKGS]
    assert got[0] == got[1], name


def test_chained_operations_and_children_match_jax():
    got = []
    for pkg, xp, _ in _PKGS:
        first, second = _dummy(pkg, xp, 2), _dummy(pkg, xp, 3)
        composed = (first + second) * 2 - 4
        composed.update()
        got.append((float(np.asarray(composed.compute())), int(first._num_updates), int(second._num_updates)))
        composed.reset()
        assert int(first._num_updates) == 0
    assert got[0] == got[1] == (6.0, 1, 1)


def _mean_metric(pkg, xp):
    class Mean(pkg.Metric):
        def __init__(self):
            kw = {"device": "cpu"} if pkg is pt else {}
            super().__init__(**kw)
            self.add_state("s", np.zeros((), np.float32), dist_reduce_fx="sum")
            self.add_state("n", np.zeros((), np.float32), dist_reduce_fx="sum")

        def update(self, x):
            self.s = self.s + xp.sum(x)
            self.n = self.n + x.shape[0]

        def compute(self):
            return self.s / xp.maximum(self.n, xp.asarray(1.0))

    return Mean()


def test_composed_forward_runs_one_forward_per_child_like_jax():
    outs = []
    for pkg, xp, conv in _PKGS:
        a, b = _mean_metric(pkg, xp), _mean_metric(pkg, xp)
        composed = a + b
        v1 = float(composed(conv(np.float32([1.0, 3.0]))))
        v2 = float(composed(conv(np.float32([5.0, 7.0]))))
        epoch = (float(a.n), float(a.s), float(composed.compute()))
        shifted = a + 10.0
        v3 = float(shifted(conv(np.float32([4.0, 4.0]))))
        c = _mean_metric(pkg, xp)
        c.compute_on_step = False
        silent = c + b
        assert silent(conv(np.float32([1.0]))) is None
        outs.append((v1, v2, *epoch, v3, float(c.n)))
    assert outs[0] == outs[1]
    assert outs[0] == (4.0, 12.0, 4.0, 16.0, 8.0, 14.0, 1.0)


def test_cache_invalidation_like_jax():
    for pkg, xp, _ in _PKGS:
        a, b = _dummy(pkg, xp, 2), _dummy(pkg, xp, 3)
        c = a + b
        c.update()
        assert float(c.compute()) == 5
        c.reset()
        a._val_to_return, b._val_to_return = 10, 20
        assert float(c.compute()) == 30
        c2 = _dummy(pkg, xp, 1) + _dummy(pkg, xp, 1)
        c2.update()
        assert float(c2.compute()) == 2
        c2.compute_on_step = False
        assert c2() is None
        c2.metric_a._val_to_return = 7
        assert float(c2.compute()) == 8


@pytest.mark.parametrize("copy", ["pickle", "clone"])
def test_composition_survives_pickle_and_clone(copy):
    f1 = pt.F1(num_classes=3, average="macro", device="cpu")
    prec = pt.Precision(num_classes=3, average="macro", device="cpu")
    composed = (f1 + prec) / 2
    rng = np.random.RandomState(0)
    batches = [(torch.softmax(torch.from_numpy(rng.rand(16, 3).astype(np.float32)), 1),
                torch.from_numpy(rng.randint(0, 3, 16))) for _ in range(3)]
    composed(*batches[0])
    twin = pickle.loads(pickle.dumps(composed)) if copy == "pickle" else composed.clone()
    for m in (composed, twin):
        for batch in batches[1:]:
            m(*batch)
    assert torch.equal(composed.compute(), twin.compute())
    # the copy's children are its own, and its update reaches them
    assert twin.metric_a.metric_a is not f1
    twin.update(*batches[0])
    assert not torch.equal(twin.metric_a.metric_a.tp, f1.tp)
    assert torch.equal(composed.compute(), (f1.compute() + prec.compute()) / 2)
