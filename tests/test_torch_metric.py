"""The Metric runtime and utils of the port against the JAX package.

A custom metric with one state of each reduction (sum, mean, min, max) runs
the same batches through both packages: per-step values, the epoch value and
the states must agree (float32 sums to rtol 1e-6). A mean state has no
pairwise merge, so both packages take the double-update ``forward`` for it.
Also: copies and pickles of a port metric are independent metrics, ``.to()``
moves the states and their defaults, and the small ``utils/data.py`` helpers
match their JAX counterparts.
"""
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt
import metrics_tpu.utils.data as jax_data
import metrics_tpu_torch as pt
import metrics_tpu_torch.utils.data as port_data
from metrics_tpu_torch.utils.prints import _WARN_ONCE_SEEN, rank_zero_warn_once

torch.set_num_threads(1)


def _reduction_metric(pkg, xp, reductions):
    class Summary(pkg.Metric):
        def __init__(self, **kw):
            super().__init__(**kw)
            for fx in reductions:
                self.add_state(fx, default=np.zeros((), np.float32), dist_reduce_fx=fx)

        def update(self, x):
            for fx in reductions:
                batch = {"sum": xp.sum(x), "mean": xp.mean(x), "min": xp.min(x), "max": xp.max(x)}[fx]
                acc = getattr(self, fx)
                merged = {"sum": acc + batch, "mean": batch, "min": xp.minimum(acc, batch),
                          "max": xp.maximum(acc, batch)}[fx]
                setattr(self, fx, merged)

        def compute(self):
            return xp.stack([getattr(self, fx) for fx in reductions])

    return Summary


@pytest.mark.parametrize("reductions", [("sum", "min", "max"), ("sum", "mean", "min", "max")])
def test_custom_metric_reductions_match_jax(reductions):
    ref = _reduction_metric(mt, jnp, reductions)()
    port = _reduction_metric(pt, torch, reductions)(device="cpu")
    assert port._fusable == ("mean" not in reductions) == ref._fusable
    rng = np.random.RandomState(0)
    for _ in range(3):
        x = rng.randn(17).astype(np.float32)
        np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(), np.asarray(ref(jnp.asarray(x))), rtol=1e-6)
    np.testing.assert_allclose(port.compute().numpy(), np.asarray(ref.compute()), rtol=1e-6)
    assert port._epoch_watermark == ref._epoch_watermark == 3
    assert port._count_bound == ref._count_bound


def test_clone_and_pickle_give_independent_metrics():
    m = pt.F1(num_classes=3, average="macro", device="cpu")
    m(torch.tensor([0, 1, 2, 1]), torch.tensor([0, 1, 1, 1]))
    for copy in (m.clone(), pickle.loads(pickle.dumps(m))):
        assert torch.equal(copy.tp, m.tp) and torch.equal(copy.compute(), m.compute())
        copy.update(torch.tensor([2, 2]), torch.tensor([2, 2]))
        assert not torch.equal(copy.tp, m.tp)  # the copy's update wrote the copy
        assert copy._epoch_watermark == m._epoch_watermark + 1


def test_to_moves_states_and_defaults():
    m = pt.Accuracy(device="cpu")
    m.to("meta")
    assert m.device == torch.device("meta") and m.correct.device == torch.device("meta")
    m.reset()
    assert m.total.device == torch.device("meta")


def test_data_helpers_match_jax():
    rng = np.random.RandomState(1)
    x = rng.rand(5, 4).astype(np.float32)
    labels = rng.randint(0, 4, 5)
    np.testing.assert_array_equal(port_data.to_categorical(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_data.to_categorical(jnp.asarray(x))))
    for num_classes in (None, 4):
        assert port_data.get_num_classes(torch.from_numpy(labels), torch.from_numpy(labels), num_classes) == \
            jax_data.get_num_classes(jnp.asarray(labels), jnp.asarray(labels), num_classes)
    for name in ("dim_zero_sum", "dim_zero_mean", "dim_zero_min", "dim_zero_max"):
        np.testing.assert_allclose(getattr(port_data, name)(torch.from_numpy(x)).numpy(),
                                   np.asarray(getattr(jax_data, name)(jnp.asarray(x))), rtol=1e-6)
    np.testing.assert_array_equal(port_data.dim_zero_cat([torch.tensor(1.0), torch.tensor([2.0, 3.0])]).numpy(),
                                  [1.0, 2.0, 3.0])
    assert port_data.apply_to_collection({"a": 2, "b": [1, 2]}, int, lambda v: v * 2) == {"a": 4, "b": [2, 4]}


def test_rank_zero_warn_once_dedups_by_message():
    _WARN_ONCE_SEEN.discard("port notice")
    with pytest.warns(UserWarning, match="port notice"):
        rank_zero_warn_once("port notice")
    import warnings

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        rank_zero_warn_once("port notice")  # second time: silent
