"""Regression: the error, moment and correlation metrics of the port against the JAX package.

The same numpy inputs (from a seed) go through ``metrics_tpu`` and
``metrics_tpu_torch`` (``device="cpu"``): the functionals, and every module
through a forward / compute / reset cycle of uneven batches.

Tolerances: integer counts must be equal. Every float value is the same
float32 formula in both packages over at most 200 terms a sum, summed in
another order (torch against XLA): rtol 1e-5, with atol 1e-6 for the
correlations, which may sit near 0 on random data. Kendall's tau counts its
pairs in int64 in the port and in float32 in the JAX package; both are exact
at these sizes, so tau agrees to one float32 rounding (rtol 1e-6), and with
scipy's float64 ``kendalltau`` to the same. The ranks of Spearman equal
``scipy.stats.rankdata`` exactly.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

import metrics_tpu as mt
import metrics_tpu.functional as mtf
import metrics_tpu_torch as pt
import metrics_tpu_torch.functional as ptf
from metrics_tpu.functional.regression.kendall import _kendall_kernel as jax_kendall_kernel
from metrics_tpu.functional.regression.spearman import _rank_data as jax_rank_data
from metrics_tpu_torch.functional.regression.kendall import _kendall_kernel
from metrics_tpu_torch.functional.regression.pearson import batch_comoments, chan_fold, chan_merge
from metrics_tpu_torch.functional.regression.spearman import _rank_data
from metrics_tpu_torch.parallel.sync import is_associative, is_mergeable, merge_values

torch.set_num_threads(1)

N, D = 64, 8
_RTOL, _ATOL_CORR = 1e-5, 1e-6
_SIZES = (N, 40, N)


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def _data(kind, seed, n=N):
    rng = np.random.RandomState(seed)
    if kind == "reg":
        t = rng.randn(n).astype(np.float32) * 2 + 1
        return (t + 0.5 * rng.randn(n)).astype(np.float32), t
    if kind == "pos":  # lognormal targets, predictions within a factor of them: MSLE and Tweedie are defined
        t = np.exp(rng.randn(n)).astype(np.float32)
        return (t * np.exp(0.1 * rng.randn(n))).astype(np.float32), t
    if kind == "multi":
        t = rng.randn(n, 3).astype(np.float32) * np.float32([1, 2, 3])
        return (t + 0.5 * rng.randn(n, 3)).astype(np.float32), t
    if kind == "dist":
        return rng.rand(n, D).astype(np.float32) + 0.01, rng.rand(n, D).astype(np.float32) + 0.01
    if kind == "logdist":
        p, q = rng.randn(n, D), rng.randn(n, D)
        lsm = lambda x: x - np.log(np.exp(x).sum(1, keepdims=True))  # noqa: E731
        return lsm(p).astype(np.float32), lsm(q).astype(np.float32)
    if kind == "emb":
        t = rng.randn(n, D).astype(np.float32)
        p = (t + rng.randn(n, D)).astype(np.float32)
        p[0] = 0  # a zero row: similarity 0
        return p, t
    if kind == "ties":  # heavy ties on both sides
        return rng.randint(0, 4, n).astype(np.float32), rng.randint(0, 3, n).astype(np.float32)
    raise ValueError(kind)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float64).numpy() if x.is_floating_point() else x.numpy()
    return np.asarray(x, dtype=np.float64) if np.asarray(x).dtype.kind == "f" else np.asarray(x)


def _close(got, want, rtol=_RTOL, atol=0.0, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol, err_msg=what)


# ------------------------------------------------------------------ functionals
_FUNCTIONALS = [
    ("mean_squared_error", {}, "reg"),
    ("mean_absolute_error", {}, "reg"),
    ("mean_squared_log_error", {}, "pos"),
    ("mean_relative_error", {}, "reg"),
    ("mean_absolute_percentage_error", {}, "reg"),
    ("symmetric_mean_absolute_percentage_error", {}, "reg"),
    ("weighted_mean_absolute_percentage_error", {}, "reg"),
    ("log_cosh_error", {}, "reg"),
    ("minkowski_distance", {"p": 1}, "reg"),
    ("minkowski_distance", {"p": 3}, "reg"),
    ("tweedie_deviance_score", {"power": 0}, "reg"),
    ("tweedie_deviance_score", {"power": 1}, "pos"),
    ("tweedie_deviance_score", {"power": 1.5}, "pos"),
    ("tweedie_deviance_score", {"power": 2}, "pos"),
    ("kl_divergence", {}, "dist"),
    ("kl_divergence", {"log_prob": True, "reduction": "sum"}, "logdist"),
    ("cosine_similarity", {}, "emb"),
    ("cosine_similarity", {"reduction": "sum"}, "emb"),
    ("cosine_similarity", {"reduction": "none"}, "emb"),
    ("explained_variance", {}, "reg"),
    ("explained_variance", {"multioutput": "raw_values"}, "multi"),
    ("explained_variance", {"multioutput": "variance_weighted"}, "multi"),
    ("r2score", {}, "reg"),
    ("r2score", {"multioutput": "raw_values"}, "multi"),
    ("r2score", {"multioutput": "variance_weighted"}, "multi"),
    ("r2score", {"adjusted": 2}, "reg"),
    ("pearson_corrcoef", {}, "reg"),
    ("concordance_corrcoef", {}, "reg"),
    ("spearman_corrcoef", {}, "reg"),
    ("spearman_corrcoef", {}, "ties"),
    ("kendall_rank_corrcoef", {}, "reg"),
    ("kendall_rank_corrcoef", {}, "ties"),
]


@pytest.mark.parametrize("name,kw,kind", _FUNCTIONALS, ids=[f"{n}-{k}-{sorted(w.items())}" for n, w, k in _FUNCTIONALS])
def test_functional_matches_jax(name, kw, kind):
    p, t = _data(kind, 1)
    want = getattr(mtf, name)(jnp.asarray(p), jnp.asarray(t), **kw)
    got = getattr(ptf, name)(torch.from_numpy(p), torch.from_numpy(t), **kw)
    assert got.dtype == torch.float32
    rtol = 1e-6 if name == "kendall_rank_corrcoef" else _RTOL
    _close(got, want, rtol=rtol, atol=_ATOL_CORR if "corrcoef" in name else 0.0, what=name)


_ERRORS = [
    ("mean_squared_error", (np.zeros(3, np.float32), np.zeros(4, np.float32)), {}),
    ("r2score", (np.zeros((3, 2, 2), np.float32), np.zeros((3, 2, 2), np.float32)), {}),
    ("r2score", (np.zeros(1, np.float32), np.zeros(1, np.float32)), {}),
    ("r2score", (np.zeros(4, np.float32), np.ones(4, np.float32)), {"multioutput": "bogus"}),
    ("explained_variance", (np.zeros(4, np.float32), np.ones(4, np.float32)), {"multioutput": "bogus"}),
    ("minkowski_distance", (np.zeros(4, np.float32), np.ones(4, np.float32)), {"p": 0.5}),
    ("tweedie_deviance_score", (np.ones(4, np.float32), np.ones(4, np.float32)), {"power": 3}),
    ("kl_divergence", (np.ones(4, np.float32), np.ones(4, np.float32)), {}),
    ("kl_divergence", (np.ones((2, 4), np.float32), np.ones((2, 4), np.float32)), {"reduction": "none"}),
    ("cosine_similarity", (np.ones(4, np.float32), np.ones(4, np.float32)), {}),
    ("cosine_similarity", (np.ones((2, 4), np.float32), np.ones((2, 4), np.float32)), {"reduction": "max"}),
    ("pearson_corrcoef", (np.ones((2, 4), np.float32), np.ones((2, 4), np.float32)), {}),
    ("spearman_corrcoef", (np.ones((2, 4), np.float32), np.ones((2, 4), np.float32)), {}),
    ("kendall_rank_corrcoef", (np.ones((2, 4), np.float32), np.ones((2, 4), np.float32)), {}),
]


@pytest.mark.parametrize("name,args,kw", _ERRORS, ids=[f"{n}-{i}" for i, (n, _, _) in enumerate(_ERRORS)])
def test_functional_errors_match_jax(name, args, kw):
    with pytest.raises(Exception) as want:
        getattr(mtf, name)(*(jnp.asarray(a) for a in args), **kw)
    with pytest.raises(want.type) as got:
        getattr(ptf, name)(*(torch.from_numpy(a) for a in args), **kw)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("name", ["pearson_corrcoef", "concordance_corrcoef", "spearman_corrcoef",
                                  "kendall_rank_corrcoef"])
def test_correlation_degenerate_inputs_match_jax(name):
    """A constant input is nan in both; so is an empty or one-sample input where the JAX package says so."""
    for p in (np.ones(6, np.float32), np.zeros(1, np.float32), np.zeros(0, np.float32)):
        t = np.arange(len(p), dtype=np.float32)
        want = float(getattr(mtf, name)(jnp.asarray(p), jnp.asarray(t)))
        got = float(getattr(ptf, name)(torch.from_numpy(p), torch.from_numpy(t)))
        assert np.isnan(want) == np.isnan(got) and (np.isnan(got) or np.isclose(got, want, rtol=_RTOL))


# ---------------------------------------------------------------------- modules
_MODULES = [
    ("MeanSquaredError", {}, "reg"),
    ("MeanAbsoluteError", {}, "reg"),
    ("MeanSquaredLogError", {}, "pos"),
    ("MeanAbsolutePercentageError", {}, "reg"),
    ("SymmetricMeanAbsolutePercentageError", {}, "reg"),
    ("WeightedMeanAbsolutePercentageError", {}, "reg"),
    ("RelativeSquaredError", {}, "reg"),
    ("RelativeSquaredError", {"num_outputs": 3, "squared": False}, "multi"),
    ("MinkowskiDistance", {"p": 3}, "reg"),
    ("LogCoshError", {}, "reg"),
    ("TweedieDevianceScore", {"power": 1.5}, "pos"),
    ("TweedieDevianceScore", {"power": 0}, "reg"),
    ("KLDivergence", {}, "dist"),
    ("KLDivergence", {"log_prob": True, "reduction": "sum"}, "logdist"),
    ("CosineSimilarity", {}, "emb"),
    ("CosineSimilarity", {"reduction": "sum"}, "emb"),
    ("CosineSimilarity", {"reduction": "none"}, "emb"),
    ("CosineSimilarity", {"reduction": "none", "capacity": 256}, "emb"),
    ("ExplainedVariance", {}, "reg"),
    ("ExplainedVariance", {"multioutput": "raw_values"}, "multi"),
    ("ExplainedVariance", {"multioutput": "variance_weighted"}, "multi"),
    ("R2Score", {}, "reg"),
    ("R2Score", {"num_outputs": 3, "multioutput": "raw_values"}, "multi"),
    ("R2Score", {"num_outputs": 3, "multioutput": "variance_weighted"}, "multi"),
    ("R2Score", {"adjusted": 2}, "reg"),
    ("PearsonCorrcoef", {}, "reg"),
    ("ConcordanceCorrCoef", {}, "reg"),
    ("SpearmanCorrcoef", {}, "ties"),
    ("SpearmanCorrcoef", {"capacity": 256}, "reg"),
    ("KendallRankCorrCoef", {}, "ties"),
    ("KendallRankCorrCoef", {"capacity": 256}, "reg"),
]
_MODULE_IDS = [f"{n}-{k}-{sorted(w.items())}" for n, w, k in _MODULES]


def _pair(name, kw):
    return getattr(mt, name)(**kw), getattr(pt, name)(device="cpu", **kw)


def _float_states(metric):
    for name, value in metric._current_state().items():
        values = getattr(value, "data", value)
        for v in values if isinstance(values, list) else [values]:
            yield name, v


@pytest.mark.parametrize("name,kw,kind", _MODULES, ids=_MODULE_IDS)
def test_module_forward_compute_reset_matches_jax(name, kw, kind):
    jm, tm = _pair(name, kw)
    corr = "Corr" in name or "Kendall" in name
    atol = _ATOL_CORR if corr else 0.0
    rtol = 1e-6 if "Kendall" in name else _RTOL
    for step, n in enumerate(_SIZES):
        p, t = _data(kind, 10 + step, n)
        want = jm(jnp.asarray(p), jnp.asarray(t))
        got = tm(torch.from_numpy(p), torch.from_numpy(t))
        _close(got, want, rtol=rtol, atol=atol, what=f"{name} step {step}")
    _close(tm.compute(), jm.compute(), rtol=rtol, atol=atol, what=f"{name} epoch")
    for state, value in tm._current_state().items():  # counts equal exactly, sums to the tolerance
        ref = getattr(jm, state)
        if isinstance(value, torch.Tensor) and not value.is_floating_point():
            assert int(value) == int(ref), state
        elif isinstance(value, torch.Tensor):
            _close(value, ref, rtol=_RTOL, atol=1e-5, what=state)
    # every float state is float32, never numpy's float64 default
    assert all(v.dtype == torch.float32 for _, v in _float_states(tm) if v.is_floating_point())
    tm.reset()
    jm.reset()
    p, t = _data(kind, 20)
    _close(tm(torch.from_numpy(p), torch.from_numpy(t)), jm(jnp.asarray(p), jnp.asarray(t)), rtol=rtol, atol=atol)
    _close(tm.compute(), jm.compute(), rtol=rtol, atol=atol, what=f"{name} after reset")


@pytest.mark.parametrize("name", ["MeanSquaredError", "MeanAbsoluteError", "MeanSquaredLogError", "ExplainedVariance",
                                  "R2Score", "RelativeSquaredError"])
def test_bf16_inputs_accumulate_in_float32_like_jax(name):
    p, t = _data("pos", 3)
    jm, tm = _pair(name, {})
    jm.update(jnp.asarray(p).astype(jnp.bfloat16), jnp.asarray(t).astype(jnp.bfloat16))
    tm.update(torch.from_numpy(p).to(torch.bfloat16), torch.from_numpy(t).to(torch.bfloat16))
    assert all(v.dtype in (torch.float32, torch.int64) for _, v in _float_states(tm))
    _close(tm.compute(), jm.compute(), what=name)
    # the same as float32 inputs holding the bfloat16-rounded values
    ref = getattr(pt, name)(device="cpu")
    ref.update(torch.from_numpy(p).to(torch.bfloat16).float(), torch.from_numpy(t).to(torch.bfloat16).float())
    assert torch.equal(tm.compute(), ref.compute())


def test_upcast_accum_leaves_float32_and_float64_alone():
    from metrics_tpu_torch.utils.data import upcast_accum

    for dtype, want in ((torch.bfloat16, torch.float32), (torch.float16, torch.float32),
                        (torch.float32, torch.float32), (torch.float64, torch.float64), (torch.int64, torch.int64)):
        assert upcast_accum(torch.zeros(2, dtype=dtype)).dtype == want


@pytest.mark.parametrize("name,kw", [("R2Score", {"adjusted": 5}), ("R2Score", {"adjusted": 3})])
def test_adjusted_r2_fallback_warnings_match_jax(name, kw):
    """With 4 samples, adjusted 5 > n - 1 and adjusted 3 == n - 1 both fall back to plain R^2, with the same warning."""
    p, t = _data("reg", 4, n=4)
    out = []
    for pkg, conv in ((mt, jnp.asarray), (pt, torch.from_numpy)):
        m = getattr(pkg, name)(**kw) if pkg is mt else getattr(pkg, name)(device="cpu", **kw)
        m.update(conv(p), conv(t))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            value = m.compute()
        out.append((float(value), [str(w.message) for w in caught]))
    assert out[0][1] == out[1][1] and out[0][1]
    np.testing.assert_allclose(out[1][0], out[0][0], rtol=_RTOL)


# ------------------------------------------------------------------ correlations
def test_pearson_state_folds_with_an_associative_merge():
    assert is_associative(chan_fold) and is_mergeable(chan_fold, torch.zeros(6))
    parts = [batch_comoments(*(torch.from_numpy(x) for x in _data("reg", s, n))) for s, n in ((1, 30), (2, 1), (3, 50))]
    folded = chan_fold(torch.stack(parts))
    pairwise = merge_values(chan_fold, merge_values(chan_fold, parts[0], parts[1]), parts[2])
    assert torch.equal(folded, pairwise) and torch.equal(folded, chan_merge(chan_merge(parts[0], parts[1]), parts[2]))
    # an empty side is exact, and the fold of the whole equals one batch over all rows
    zero = torch.zeros(6)
    assert torch.equal(chan_merge(zero, parts[0]), parts[0]) and torch.equal(chan_merge(parts[0], zero), parts[0])
    allp, allt = (np.concatenate(x) for x in zip(*(_data("reg", s, n) for s, n in ((1, 30), (2, 1), (3, 50)))))
    _close(folded, batch_comoments(torch.from_numpy(allp), torch.from_numpy(allt)), rtol=1e-5, atol=1e-5)


class _CountingPearson(pt.PearsonCorrcoef):
    calls = 0

    def update(self, preds, target):
        type(self).calls += 1
        super().update(preds, target)


@pytest.mark.parametrize("sync_fn", [None, lambda x: [x, x]], ids=["local", "dist_sync_on_step"])
def test_pearson_forward_makes_one_update_like_jax(sync_fn):
    """The one-delta forward merges with ``chan_fold``: one update a forward, not the double update."""
    _CountingPearson.calls = 0
    kw = {} if sync_fn is None else {"dist_sync_on_step": True, "dist_sync_fn": sync_fn}
    tm = _CountingPearson(device="cpu", **kw)
    jm = mt.PearsonCorrcoef(**kw)
    assert tm._fusable
    for step, n in enumerate(_SIZES):
        p, t = _data("reg", 30 + step, n)
        _close(tm(torch.from_numpy(p), torch.from_numpy(t)), jm(jnp.asarray(p), jnp.asarray(t)), atol=_ATOL_CORR)
        assert _CountingPearson.calls == step + 1
    _close(tm.compute(), jm.compute(), atol=_ATOL_CORR)
    assert int(tm.n_total) == sum(_SIZES) == float(tm.comoments[0])


def test_pearson_warns_past_the_float32_count():
    """Past 2**24 samples the float32 n of the vector stops growing; the int64 count does not, and compute warns."""
    m = pt.PearsonCorrcoef(device="cpu")
    x = torch.arange(2**23, dtype=torch.float32) % 1024  # M2x * M2y stays below float32's range
    m.update(x, -x)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        m.compute()
    assert not caught
    m.update(x, -x)
    m.update(x[:1], -x[:1])
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        value = m.compute()
    assert any("saturates at 2^24" in str(w.message) for w in caught)
    assert int(m.n_total) == 2**24 + 1 and float(m.comoments[0]) == 2.0**24  # the float32 count is stuck
    assert float(value) == pytest.approx(-1.0, abs=1e-5)


@pytest.mark.parametrize("name", ["spearman_corrcoef", "pearson_corrcoef"])
def test_correlation_denominator_does_not_overflow_where_jax_returns_zero(name):
    """The JAX package takes ``sqrt(var_x * var_y)`` in float32, which overflows (here Spearman's
    rank variances at 130,000 samples, Pearson's co-moments of values ~1e8) and returns 0; the
    port takes ``sqrt(var_x) * sqrt(var_y)`` and equals scipy. Below the overflow both agree (the
    other tests of this file)."""
    rng = np.random.RandomState(7)
    n = 130_000
    x = rng.rand(n).astype(np.float32) * (1 if name == "spearman_corrcoef" else 1e8)
    y = (x + rng.randn(n) * x.std()).astype(np.float32)
    assert float(getattr(mtf, name)(jnp.asarray(x), jnp.asarray(y))) == 0.0  # the reference's overflow
    want = (scipy.stats.spearmanr if name == "spearman_corrcoef" else scipy.stats.pearsonr)(x, y).statistic
    got = float(getattr(ptf, name)(torch.from_numpy(x), torch.from_numpy(y)))
    assert got == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("seed,high", [(0, 3), (1, 2), (2, 50), (3, 10_000)])
def test_spearman_ranks_equal_scipy_and_jax(seed, high):
    """Heavy ties (2 or 3 distinct values) to few: the average ranks are exact."""
    rng = np.random.RandomState(seed)
    x = rng.randint(0, high, 301).astype(np.float32)
    got = _rank_data(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, scipy.stats.rankdata(x).astype(np.float32))
    np.testing.assert_array_equal(got, np.asarray(jax_rank_data(jnp.asarray(x))))
    y = rng.randint(0, 3, 301).astype(np.float32)
    value = float(ptf.spearman_corrcoef(torch.from_numpy(x), torch.from_numpy(y)))
    assert value == pytest.approx(scipy.stats.spearmanr(x, y).statistic, rel=1e-5, abs=_ATOL_CORR)
    assert value == pytest.approx(float(mtf.spearman_corrcoef(jnp.asarray(x), jnp.asarray(y))), rel=1e-6, abs=_ATOL_CORR)


def test_spearman_ranks_put_nans_last_each_its_own_run_like_jax():
    x = np.float32([3.0, np.nan, 1.0, 3.0, -np.nan, -np.inf, np.inf, 1.0])
    np.testing.assert_array_equal(_rank_data(torch.from_numpy(x)).numpy(), np.asarray(jax_rank_data(jnp.asarray(x))))


@pytest.mark.parametrize("block_rows", [1, 7, 16, 49, 50, 64, None])
def test_kendall_blocks_that_do_not_divide_n_give_the_same_tau(block_rows):
    p, t = _data("ties", 5, n=50)
    q, u = torch.from_numpy(p), torch.from_numpy(t)
    got = _kendall_kernel(q, u, block_rows=block_rows)
    assert torch.equal(got, _kendall_kernel(q, u, block_rows=50))
    assert float(got) == pytest.approx(scipy.stats.kendalltau(p, t).statistic, rel=1e-6)
    assert float(got) == pytest.approx(float(jax_kendall_kernel(jnp.asarray(p), jnp.asarray(t))), rel=1e-6)


@pytest.mark.parametrize("bad", [np.nan, np.inf, -np.inf])
def test_kendall_is_nan_on_a_non_finite_input_like_jax(bad):
    p, t = _data("reg", 6, n=20)
    p[3] = bad
    want = float(jax_kendall_kernel(jnp.asarray(p), jnp.asarray(t)))
    got = float(_kendall_kernel(torch.from_numpy(p), torch.from_numpy(t), block_rows=3))
    assert np.isnan(want) and np.isnan(got)


@pytest.mark.parametrize("name", ["SpearmanCorrcoef", "KendallRankCorrCoef"])
@pytest.mark.parametrize("approx", ["sketch", "qsketch", "bogus"])
def test_rank_correlation_approx_modes_raise(name, approx):
    if approx == "bogus":
        with pytest.raises(ValueError, match="approx"):
            getattr(pt, name)(approx=approx, device="cpu")
        return
    # the sketch modes are ported: the port builds the reference's joint state
    # (tests/test_torch_sketch.py holds their values)
    port, ref = getattr(pt, name)(approx=approx, device="cpu"), getattr(mt, name)(approx=approx)
    assert tuple(port.joint.counts.shape) == tuple(ref.joint.counts.shape)
    assert type(port.joint).__name__ == type(ref.joint).__name__


def test_rank_correlations_keep_every_row_in_order_in_both_state_kinds():
    batches = [_data("reg", 40 + s, n) for s, n in enumerate(_SIZES)]
    listed, buffered = pt.SpearmanCorrcoef(device="cpu"), pt.SpearmanCorrcoef(capacity=256, device="cpu")
    for p, t in batches:
        for m in (listed, buffered):
            m.update(torch.from_numpy(p), torch.from_numpy(t))
    assert isinstance(listed.preds_all, list) and len(listed.preds_all) == 3
    want = np.concatenate([p for p, _ in batches])
    for m in (listed, buffered):
        np.testing.assert_array_equal(m._epoch()[0].numpy(), want)
    assert torch.equal(listed.compute(), buffered.compute())
