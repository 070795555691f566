"""Quantile, Percentile and MedianAbsoluteError of the port against the JAX package and a float64 oracle.

The same numpy inputs (from a seed) go through ``metrics_tpu`` and
``metrics_tpu_torch`` (``device="cpu"``): latencies (lognormal, exact zeros,
outliers, NaN and ``+inf``), signed values, and regression pairs.

Tolerances:

* the sketch counts equal the JAX package's bit for bit on data more than the
  JAX package's float32-``log`` error band away from every bucket edge (the
  band is ``tests/test_torch_sketch.py``'s; there the port takes the
  float64-exact bucket and the JAX package may be one bucket off);
* each estimate is a bucket's representative value, so it equals the JAX
  package's to rtol 1e-6 (one float32 rounding of the same float64 value);
* against ``np.quantile`` of the samples but NaN (``method="lower"``, the rank
  the sketch selects), each estimate is within its ``error_bound()``:
  ``|estimate - true| <= alpha * |true| + min_value``;
* the error bounds equal the JAX package's exactly.
"""
import copy
import pickle
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt
import metrics_tpu.parallel.qsketch as jqs
import metrics_tpu_torch as pt
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.parallel import qsketch as qs
from tests.test_torch_sketch import _near_edge

torch.set_num_threads(1)

RTOL_VALUE = 1e-6
_GRID = (qs.QSKETCH_ALPHA, qs.QSKETCH_MIN_VALUE, qs.QSKETCH_MAX_VALUE)


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def _latencies(seed, n):
    """Lognormal request latencies in seconds (20 ms median), 0.1% outliers at 50x, exact zeros, NaN and +inf."""
    rng = np.random.default_rng(seed)
    x = 0.02 * rng.lognormal(0.0, 1.0, n)
    x[rng.random(n) < 0.001] *= 50
    x[rng.random(n) < 0.002] = 0.0
    x = x.astype(np.float32)
    x[:3] = [np.nan, np.inf, np.nan]
    return x


def _signed(seed, n):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * 10 ** rng.uniform(-3, 3, n)).astype(np.float32)


def _off_edges(x, grid=_GRID):
    """``x`` without the values inside the JAX package's error band of an edge."""
    return x[~_near_edge(np.nan_to_num(x, posinf=0.0), grid)]


def _within_bound(est, bound, samples, q, alpha, min_value):
    true = np.quantile(samples.astype(np.float64), q, method="lower")
    assert np.all(np.abs(est - true) <= alpha * np.abs(true) + min_value + 1e-12 * np.abs(true)), (est, true)
    assert np.all(bound == alpha)


@pytest.mark.parametrize("q", [0.5, (0.5, 0.9, 0.99, 0.999), (0.0, 1.0)])
@pytest.mark.parametrize("data", ["latency", "signed"])
def test_quantile_equals_jax_and_the_float64_oracle(q, data):
    make = _latencies if data == "latency" else _signed
    batches = [_off_edges(make(seed, n)) for seed, n in ((1, 3_000), (2, 2_000), (3, 3_500))]
    port, ref = pt.Quantile(q=q, device="cpu"), mt.Quantile(q=q)
    for x in batches:
        np.testing.assert_allclose(port(torch.from_numpy(x)).numpy(), np.asarray(ref(jnp.asarray(x))),
                                   rtol=RTOL_VALUE)
    np.testing.assert_array_equal(port.qsketch.counts.numpy(), np.asarray(ref.qsketch.counts))
    est = port.compute().numpy()
    np.testing.assert_allclose(est, np.asarray(ref.compute()), rtol=RTOL_VALUE)
    bound = port.error_bound().numpy()
    np.testing.assert_array_equal(bound, np.asarray(ref.error_bound()))
    epoch = np.concatenate(batches)
    if 1.0 in np.atleast_1d(q) and data == "latency":  # the +inf samples sit in the overflow bucket: uncertified
        assert np.isinf(bound[-1])
        est, bound, q = est[:-1], bound[:-1], np.atleast_1d(q)[:-1]
    _within_bound(est, bound, epoch[~np.isnan(epoch)], q, *_GRID[:2])


@pytest.mark.parametrize("p", [50, (50, 99, 99.9)])
def test_percentile_is_quantile_on_the_0_100_scale(p):
    x = _off_edges(_latencies(4, 5_000))
    port, ref = pt.Percentile(p, device="cpu"), mt.Percentile(p)
    port.update(torch.from_numpy(x))
    ref.update(jnp.asarray(x))
    np.testing.assert_allclose(port.compute().numpy(), np.asarray(ref.compute()), rtol=RTOL_VALUE)
    q = pt.Quantile(np.asarray(p) / 100.0, device="cpu")
    q.update(torch.from_numpy(x))
    np.testing.assert_array_equal(port.compute().numpy(), q.compute().numpy())
    assert port.q == ref.q and repr(port) == repr(ref).replace("metrics_tpu.", "")


def test_median_absolute_error_equals_jax_and_the_oracle():
    rng = np.random.default_rng(5)
    batches = []
    for n in (2_000, 1_500, 2_500):
        t = rng.lognormal(0.0, 1.0, n).astype(np.float32)
        p = (t * np.exp(0.1 * rng.standard_normal(n))).astype(np.float32)
        p[:2] = [np.nan, t[1] + np.float32(np.inf)]
        err = np.abs(p - t)
        keep = ~_near_edge(np.nan_to_num(err, posinf=0.0), _GRID)
        batches.append((p[keep], t[keep]))
    port, ref = pt.MedianAbsoluteError(device="cpu"), mt.MedianAbsoluteError()
    for p, t in batches:
        np.testing.assert_allclose(port(torch.from_numpy(p), torch.from_numpy(t)).numpy(),
                                   np.asarray(ref(jnp.asarray(p), jnp.asarray(t))), rtol=RTOL_VALUE)
    np.testing.assert_array_equal(port.qsketch.counts.numpy(), np.asarray(ref.qsketch.counts))
    np.testing.assert_allclose(port.compute().numpy(), np.asarray(ref.compute()), rtol=RTOL_VALUE)
    err = np.concatenate([np.abs(p - t) for p, t in batches])
    _within_bound(port.compute().numpy(), port.error_bound().numpy(), err[~np.isnan(err)], 0.5, *_GRID[:2])
    assert float(port.error_bound()) == float(ref.error_bound())


def test_empty_sketch_is_nan_and_rank_selection_matches_the_float32_target():
    q = pt.Quantile(q=(0.5, 0.99), device="cpu")
    assert np.all(np.isnan(q.compute().numpy())) and np.all(np.isnan(q.error_bound().numpy()))
    # 101 samples, one a bucket: q * (n - 1) = 0.99 * 100 rounds to 99.0 in float32, as the JAX package
    # computes it, and selects the bucket after the 99th (float64 would give 98.99999999999999)
    x = (1.0 * 1.05 ** np.arange(101)).astype(np.float32)
    for qq in (0.99, 0.5, 0.37):
        port, ref = pt.Quantile(q=qq, device="cpu"), mt.Quantile(q=qq)
        port.update(torch.from_numpy(x))
        ref.update(jnp.asarray(x))
        assert float(port.compute()) == pytest.approx(float(ref.compute()), rel=RTOL_VALUE)


def test_quantile_from_counts_past_2_24_samples_stays_exact():
    grid = (0.1, 1e-6, 1e6)
    b = qs.qsketch_num_buckets(*grid)
    counts = torch.zeros(b, dtype=torch.int64)
    counts[100], counts[200] = 2**24 + 1, 2**24 + 3  # the median is the first sample of bucket 200
    est = qs.quantile_from_counts(counts, 0.5, *grid)
    assert float(est) == pytest.approx(float(qs.qsketch_bucket_values(*grid)[200]), rel=RTOL_VALUE)


def test_quantile_family_groups_and_mae_apart():
    col = pt.MetricCollection({
        "p50": pt.Quantile(q=0.5, device="cpu"), "p99": pt.Percentile(99, device="cpu"),
        "tail": pt.Quantile(q=(0.9, 0.999), device="cpu"), "coarse": pt.Quantile(alpha=0.05, device="cpu"),
        "mae": pt.MedianAbsoluteError(device="cpu"),
    })
    assert sorted(col.compute_groups.values()) == [("coarse",), ("mae",), ("p50", "p99", "tail")]
    assert col["mae"]._group_fingerprint()[0] == "qsketch_mae"
    x = torch.from_numpy(_latencies(6, 1_000))
    out = pt.MetricCollection({k: v for k, v in col.items() if k != "mae"})(x)
    for k in ("p50", "p99", "tail"):
        assert torch.equal(col[k].qsketch.counts, col["p50"].qsketch.counts)
        assert torch.equal(out[k], col[k].compute())


def test_validation_errors_equal_jax():
    for kw in ({"q": 1.5}, {"q": ()}, {"q": (0.5, -0.1)}, {"alpha": 1.0}, {"min_value": 2e9}):
        with pytest.raises(ValueError) as ref_err:
            mt.Quantile(**kw)
        with pytest.raises(ValueError) as port_err:
            pt.Quantile(device="cpu", **kw)
        assert str(port_err.value) == str(ref_err.value)
    with pytest.raises(RuntimeError, match="same shape"):
        pt.MedianAbsoluteError(device="cpu").update(torch.zeros(3), torch.zeros(4))


@pytest.mark.parametrize("cls", ["Quantile", "MedianAbsoluteError"])
def test_jax_checkpoint_loads_and_reset_copies_pickle(cls):
    x = _off_edges(_latencies(7, 4_000))
    args = (x,) if cls == "Quantile" else (x, np.zeros_like(x))
    ref = getattr(mt, cls)()
    ref.update(*(jnp.asarray(a) for a in args))
    ref.persistent(True)
    state = ref.state_dict()
    assert set(state["qsketch"]) == {"sketch_counts"}
    port = getattr(pt, cls)(device="cpu")
    port.load_state_dict(state)
    assert isinstance(port.qsketch, qs.QuantileSketch) and port.qsketch.counts.dtype == torch.int64
    assert float(port.compute()) == pytest.approx(float(ref.compute()), rel=RTOL_VALUE)
    for other in (copy.deepcopy(port), pickle.loads(pickle.dumps(port))):
        assert torch.equal(other.qsketch.counts, port.qsketch.counts)
        other.update(*(torch.from_numpy(a) for a in args))
        assert int(other.qsketch.counts.sum()) == 2 * int(port.qsketch.counts.sum())
    port.reset()
    assert int(port.qsketch.counts.sum()) == 0 and isinstance(port, Metric)


def test_qsketch_update_drops_nan_and_keeps_inf_in_the_overflow_buckets():
    x = np.float32([np.nan, np.inf, -np.inf, 0.0, -0.0, 1e-12, 5.0])
    b = qs.qsketch_num_buckets(*_GRID)
    got = qs.qsketch_update(torch.zeros(b, dtype=torch.int64), torch.from_numpy(x), *_GRID)
    want = jqs.qsketch_update(jnp.zeros(b, jnp.int32), jnp.asarray(x), *_GRID)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[0]) == 1 and int(got[-1]) == 1 and int(got[b // 2]) == 3 and int(got.sum()) == 6
