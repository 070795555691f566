"""Binned threshold counting: the port's plain version against the JAX package.

``metrics_tpu_torch.ops.binned.binned_stat_counts(impl="torch")`` is held
against ``metrics_tpu.ops.binned.binned_stat_counts`` under both
``impl="xla"`` and ``impl="pallas_interpret"`` (the Pallas kernel in interpret
mode, as ``tests/functional/test_ops_binned.py`` runs it), on the same inputs
made with numpy from a seed.

Tolerances: with bool (0/1) weights the counts are integers and must be
bit-exact. With float weights both sides sum float32 products in different
orders (the port accumulates in float64), so they agree to rtol 1e-5.

The CUDA kernel itself runs only on the GPU: its tests are in
``tests/test_torch_kernels.py``, marked ``cuda``.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from metrics_tpu.ops.binned import binned_stat_counts as jax_counts
from metrics_tpu_torch.ops.binned import binned_counts_cuda, binned_stat_counts

torch.set_num_threads(1)

_FLOAT_RTOL = 1e-5


def _inputs(n, c, t, seed, weights="bool", sort=True):
    rng = np.random.RandomState(seed)
    preds = rng.rand(n, c).astype(np.float32)
    pos = rng.rand(n, c) > 0.5
    if weights == "bool":
        neg = ~pos
    else:
        pos = (rng.rand(n, c) * pos).astype(np.float32)
        neg = rng.rand(n, c).astype(np.float32)
    thr = rng.rand(t).astype(np.float32)
    if sort:
        thr = np.sort(thr)
    return preds, pos, neg, thr


def _port(preds, pos, neg, thr):
    tp, fp = binned_stat_counts(torch.from_numpy(preds), torch.from_numpy(pos), torch.from_numpy(neg),
                                torch.from_numpy(thr), impl="torch")
    return tp.numpy(), fp.numpy()


def _jax(preds, pos, neg, thr, impl):
    tp, fp = jax_counts(jnp.asarray(preds), jnp.asarray(pos), jnp.asarray(neg), jnp.asarray(thr), impl=impl)
    return np.asarray(tp), np.asarray(fp)


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize(
    "n,t",
    [
        (37, 5),  # everything unaligned, single partial tile
        (256, 100),  # T not lane-aligned
        (2047, 64),  # tile edge - 1
        (2048, 128),  # exactly one tile
        (2049, 64),  # tile edge + 1
        (5000, 129),  # several tiles, T across a lane boundary
    ],
)
def test_bool_weights_bit_exact(n, t, impl):
    preds, pos, neg, thr = _inputs(n, 1, t, seed=n + t)
    got, want = _port(preds, pos, neg, thr), _jax(preds, pos, neg, thr, impl)
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == (1, t)
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("n,t", [(37, 5), (2049, 64)])
def test_float_weights_within_tolerance(n, t, impl):
    preds, pos, neg, thr = _inputs(n, 1, t, seed=7 * n + t, weights="float")
    for g, w in zip(_port(preds, pos, neg, thr), _jax(preds, pos, neg, thr, impl)):
        np.testing.assert_allclose(g, w, rtol=_FLOAT_RTOL, atol=0)


@pytest.mark.parametrize("n,c,t", [(100, 3, 7), (513, 32, 100), (0, 3, 5), (0, 1, 5)])
def test_multiclass_and_empty(n, c, t):
    """C > 1 and N == 0: per-class counts, (C, T) shaped, equal to the JAX package."""
    preds, pos, neg, thr = _inputs(n, c, t, seed=c + t)
    for impl in ("xla", "pallas_interpret"):
        for g, w in zip(_port(preds, pos, neg, thr), _jax(preds, pos, neg, thr, impl)):
            assert g.shape == (c, t)
            np.testing.assert_array_equal(g, w)


def test_threshold_boundary_equality():
    """A score exactly on a threshold counts (inclusive >=)."""
    preds = np.asarray([[0.5], [0.25], [0.75]], dtype=np.float32)
    pos = np.asarray([[True], [True], [False]])
    thr = np.asarray([0.25, 0.5, 0.75], dtype=np.float32)
    tp, fp = _port(preds, pos, ~pos, thr)
    np.testing.assert_array_equal(tp[0], [2.0, 1.0, 0.0])
    np.testing.assert_array_equal(fp[0], [1.0, 1.0, 1.0])
    for g, w in zip((tp, fp), _jax(preds, pos, ~pos, thr, "xla")):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", ["unsorted", "duplicates"])
def test_unsorted_and_duplicate_thresholds(case):
    preds, pos, neg, thr = _inputs(300, 1, 40, seed=3, sort=False)
    if case == "duplicates":
        thr = np.concatenate([thr, thr[:10], np.asarray([0.5, 0.5], np.float32)])
    got = _port(preds, pos, neg, thr)
    for g, w in zip(got, _jax(preds, pos, neg, thr, "xla")):
        np.testing.assert_array_equal(g, w)
    # each threshold's count is independent of the order the grid is given in
    order = np.argsort(thr, kind="stable")
    for g, s in zip(got, _port(preds, pos, neg, thr[order])):
        np.testing.assert_array_equal(g[:, order], s)


def test_nan_and_inf_scores():
    """NaN counts at no threshold; -inf only at a -inf threshold; +inf at every threshold."""
    preds = np.asarray([[np.nan], [-np.inf], [np.inf], [0.5], [np.nan]], dtype=np.float32)
    pos = np.asarray([[True], [True], [True], [False], [False]])
    thr = np.asarray([-np.inf, 0.0, 0.5, 1.0, np.inf], dtype=np.float32)
    tp, fp = _port(preds, pos, ~pos, thr)
    np.testing.assert_array_equal(tp[0], [2, 1, 1, 1, 1])
    np.testing.assert_array_equal(fp[0], [1, 1, 1, 0, 0])
    for g, w in zip((tp, fp), _jax(preds, pos, ~pos, thr, "xla")):
        np.testing.assert_array_equal(g, w)


def test_impl_cuda_on_cpu_tensor_raises():
    preds, pos, neg, thr = _inputs(10, 1, 4, seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        binned_stat_counts(torch.from_numpy(preds), torch.from_numpy(pos), torch.from_numpy(neg),
                           torch.from_numpy(thr), impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        binned_counts_cuda(torch.from_numpy(preds[:, 0]), torch.from_numpy(pos[:, 0]),
                           torch.from_numpy(neg[:, 0]), torch.from_numpy(thr))
    with pytest.raises(ValueError, match="impl"):
        binned_stat_counts(torch.from_numpy(preds), torch.from_numpy(pos), torch.from_numpy(neg),
                           torch.from_numpy(thr), impl="pallas")


def test_auto_on_cpu_runs_plain_version():
    preds, pos, neg, thr = _inputs(64, 1, 9, seed=5)
    before = binned_counts_cuda.launches
    auto = binned_stat_counts(*(torch.from_numpy(x) for x in (preds, pos, neg, thr)))
    for g, w in zip(auto, _port(preds, pos, neg, thr)):
        np.testing.assert_array_equal(g.numpy(), w)
    assert binned_counts_cuda.launches == before


def test_plain_version_chunks_large_n(monkeypatch):
    """The plain version bounds its intermediate by chunking N: chunked and
    one-shot contractions agree exactly."""
    import metrics_tpu_torch.ops.binned as ops

    preds, pos, neg, thr = _inputs(1000, 2, 33, seed=9)
    one_shot = _port(preds, pos, neg, thr)
    monkeypatch.setattr(ops, "_PLAIN_CHUNK_ELEMENTS", 33 * 2 * 7)  # 7 rows per chunk
    chunked = _port(preds, pos, neg, thr)
    for a, b in zip(one_shot, chunked):
        np.testing.assert_array_equal(a, b)

