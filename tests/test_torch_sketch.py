"""Histogram, rank and quantile sketch states of the port against the JAX package.

The same numpy inputs (from a seed) go through ``metrics_tpu`` and
``metrics_tpu_torch`` (``device="cpu"``):

* binning: the linear grid (``score_to_bin``) and the soft-sign rank grid
  (``rank_to_bin``) give the JAX package's bins bit for bit, ``±inf`` in the
  end bins; the curve and joint updates give its counts bit for bit (binary,
  multiclass and multilabel layouts, NaN dropped);
* the qsketch grid bins by comparison with float32 edges rounded up from
  float64, so every value lands in its float64-exact bucket (checked against a
  numpy float64 oracle); every sample more than 2 ulps from an edge lands where
  the JAX package's float32 ``log`` puts it, and the rest move by one bucket;
* the curve math, Spearman / Kendall from joint counts and the error and
  collision bounds, against the JAX package and float64 oracles (numpy's
  Mann-Whitney statistic of the binned data, ``scipy.stats.spearmanr`` /
  ``kendalltau`` of the bin indices);
* the metric modules (``approx="sketch"`` / ``"qsketch"``) through forward /
  compute / reset, cross-class compute groups, the rejections, checkpoints of
  the JAX package loaded into the port, ``reset``, deepcopy and pickle.

Tolerances: every bin and count is an integer and must be equal. The port
computes the curve and rank math in float64 from its int64 counts and rounds
once to float32; the JAX package computes in float32 (exact counts at these
sizes, sums over up to 2,049 terms): rtol 1e-5 against the JAX package, and
1e-6 against the float64 oracles (one float32 rounding). The JAX package's
Spearman denominator overflows float32 past ~6 million samples (a reference
fault, ROADMAP section 3): there the port is held to the float64 oracle alone.
"""
import copy
import pickle
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

import metrics_tpu as mt
import metrics_tpu.parallel.qsketch as jqs
import metrics_tpu.parallel.sketch as jsk
import metrics_tpu_torch as pt
from metrics_tpu.core.metric import Metric as JaxMetric
from metrics_tpu_torch.core.metric import Metric
from metrics_tpu_torch.parallel import qsketch as qs
from metrics_tpu_torch.parallel import sketch as sk
from metrics_tpu_torch.parallel.sync import host_gather, is_mergeable, merge_values

torch.set_num_threads(1)

RTOL_JAX, RTOL_ORACLE = 1e-5, 1e-6


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _scores(seed, n, lo=0.0, hi=1.0, extras=True):
    rng = np.random.default_rng(seed)
    x = (lo + (hi - lo) * rng.random(n)).astype(np.float32)
    if extras:
        x[:6] = [np.inf, -np.inf, lo - 1.0, hi + 3.0, lo, hi]
    return x


# ------------------------------------------------------------------ binning
@pytest.mark.parametrize("num_bins,lo,hi", [(512, 0.0, 1.0), (2048, 0.0, 1.0), (100, -3.0, 5.0), (7, 0.25, 0.75)])
def test_score_to_bin_equals_jax(num_bins, lo, hi):
    x = _scores(1, 4_000, lo, hi)
    edges = (lo + np.arange(num_bins + 1) * ((hi - lo) / num_bins)).astype(np.float32)
    x = np.concatenate([x, edges, np.nextafter(edges, np.float32(np.inf)), np.nextafter(edges, np.float32(-np.inf))])
    got = sk.score_to_bin(torch.from_numpy(x), num_bins, lo, hi)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsk.score_to_bin(jnp.asarray(x), num_bins, lo, hi)))
    assert got[0] == num_bins - 1 and got[1] == 0  # +-inf in the end bins


@pytest.mark.parametrize("num_bins,grid", [(512, None), (64, None), (512, (-2.0, 2.0))])
def test_rank_to_bin_equals_jax(num_bins, grid):
    rng = np.random.default_rng(2)
    x = (rng.lognormal(0.0, 3.0, 4_000) * rng.choice([-1, 1], 4_000)).astype(np.float32)
    x[:5] = [np.inf, -np.inf, 0.0, -0.0, 1e-30]
    lo, hi = grid if grid is not None else (None, None)
    got = sk.rank_to_bin(torch.from_numpy(x), num_bins, lo, hi)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jsk.rank_to_bin(jnp.asarray(x), num_bins, lo, hi)))


def _layout(kind, seed, n=300, c=4):
    rng = np.random.default_rng(seed)
    if kind == "binary":
        preds, target = _scores(seed, n), (rng.random(n) < 0.35).astype(np.int64)
    elif kind == "multiclass":
        preds, target = rng.random((n, c)).astype(np.float32), rng.integers(0, c, n)
    else:
        preds, target = rng.random((n, c)).astype(np.float32), (rng.random((n, c)) < 0.4).astype(np.int64)
    preds = preds.copy()
    preds.reshape(-1)[7:10] = np.nan
    return preds, target


@pytest.mark.parametrize("kind", ["binary", "multiclass", "multilabel"])
@pytest.mark.parametrize("pos_label", [1, 0])
def test_curve_update_counts_equal_jax(kind, pos_label):
    preds, target = _layout(kind, 3)
    shape = (2, 64) if kind == "binary" else (4, 2, 64)
    want = jsk.sketch_curve_update(jnp.zeros(shape, jnp.int32), jnp.asarray(preds), jnp.asarray(target), 0.0, 1.0,
                                   pos_label)
    got = sk.sketch_curve_update(torch.zeros(shape, dtype=torch.int64), torch.from_numpy(preds),
                                 torch.from_numpy(target), 0.0, 1.0, pos_label)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) == np.isfinite(preds).sum() + np.isinf(preds).sum()  # NaN dropped


@pytest.mark.parametrize("grid", [None, (0.0, 3.0)])
def test_rank_update_counts_equal_jax(grid):
    rng = np.random.default_rng(4)
    p = rng.lognormal(0.0, 1.0, 500).astype(np.float32)
    t = (p * np.exp(0.3 * rng.standard_normal(500))).astype(np.float32)
    p[3], t[5], p[9], t[9] = np.nan, np.nan, np.inf, -np.inf
    lo, hi = grid if grid is not None else (None, None)
    want = jsk.sketch_rank_update(jnp.zeros((32, 32), jnp.int32), jnp.asarray(p), jnp.asarray(t), lo, hi)
    got = sk.sketch_rank_update(torch.zeros(32, 32, dtype=torch.int64), torch.from_numpy(p), torch.from_numpy(t),
                                lo, hi)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) == 498


# -------------------------------------------------------------- qsketch grid
_GRIDS = [(0.01, 1e-9, 1e9), (0.1, 1e-6, 1e6), (0.01, 1e-6, 1e6)]


def _exact_edges(alpha, min_value, max_value):
    m, gamma = jqs._grid_params(alpha, min_value, max_value)
    return min_value * gamma ** np.arange(m + 1, dtype=np.float64)


def _exact_buckets(x, grid):
    """The float64-exact qsketch bucket of each float32 value (numpy oracle)."""
    edges = _exact_edges(*grid)
    mag = np.abs(x.astype(np.float64))
    return len(edges) + np.sign(x).astype(np.int64) * np.searchsorted(edges, mag, side="right")


def _near_edge(x, grid):
    """Whether each float32 value lies within the JAX package's error band of an
    edge: 2 ulps, plus the error of its float32 ``log``. That log's result ``t =
    ln(|x| / min_value)`` is good to about an ulp of itself, ``|t| 2^-23``,
    which is up to ``2 |t|`` ulps of ``x``; the band doubles it."""
    edges = _exact_edges(*grid)
    mag = np.abs(x.astype(np.float64))
    right = np.clip(np.searchsorted(edges, mag), 0, len(edges) - 1)
    nearest = np.minimum(np.abs(edges[right] - mag), np.abs(edges[np.clip(right - 1, 0, None)] - mag))
    band = 2 + 4 * np.abs(np.log(np.maximum(mag, grid[1]) / grid[1]))
    return nearest <= band * np.spacing(np.abs(x)).astype(np.float64)


def _edge_set(grid, ulps=64):
    """Every edge of ``grid`` in float32 and its neighbours up to ``ulps`` ulps away, both signs."""
    e = _exact_edges(*grid).astype(np.float32)
    ring, up, down = [e], e, e
    for _ in range(ulps):
        up, down = np.nextafter(up, np.float32(np.inf)), np.nextafter(down, np.float32(-np.inf))
        ring += [up, down]
    ring = np.concatenate(ring)
    return np.concatenate([ring, -ring])


@pytest.mark.parametrize("grid", _GRIDS)
def test_qsketch_buckets_are_exact_and_equal_jax_off_the_edges(grid):
    rng = np.random.default_rng(5)
    n = 200_000
    x = 10 ** rng.uniform(np.log10(grid[1]) - 1, np.log10(grid[2]) + 1, n) * rng.choice([-1, 1], n)
    x = np.concatenate([x.astype(np.float32), _edge_set(grid), np.float32([0.0, -0.0, np.inf, -np.inf, 1e-38, -3e38])])
    got = qs.qsketch_bucket(torch.from_numpy(x), *grid).numpy()
    exact = _exact_buckets(x, grid)
    np.testing.assert_array_equal(got, exact)  # every value in its float64-exact bucket
    assert got.min() == 0 and got.max() == jqs.qsketch_num_buckets(*grid) - 1
    ref = np.asarray(jqs.qsketch_bucket(jnp.asarray(x), *grid))
    near = _near_edge(x, grid)
    np.testing.assert_array_equal(got[~near], ref[~near])
    moved = got != ref
    assert np.all(np.abs(got[moved] - ref[moved]) == 1), "a moved sample moved by more than one bucket"
    edges = _exact_edges(*grid)
    mag = np.abs(x[moved].astype(np.float64))
    k = np.clip(np.searchsorted(edges, mag), 1, len(edges) - 1)
    ulps = np.minimum(np.abs(edges[k] - mag), np.abs(edges[k - 1] - mag)) / np.spacing(np.abs(x[moved]))
    print(f"\nqsketch grid {grid}: {moved[:n].sum()} of {n} log-uniform samples and {moved[n:].sum()} of"
          f" {x.size - n} edge-ring samples in another bucket than the JAX package's, each one bucket away and"
          f" at most {ulps.max():.1f} ulps from an edge; the JAX package is off the float64-exact bucket for"
          f" {(ref != exact).sum()} of them")


def test_qsketch_bucket_values_and_edges_follow_the_grid():
    for grid in _GRIDS:
        np.testing.assert_array_equal(qs.qsketch_bucket_values(*grid), jqs.qsketch_bucket_values(*grid))
        assert qs.qsketch_num_buckets(*grid) == jqs.qsketch_num_buckets(*grid)
        e = qs.qsketch_bucket_edges(*grid)
        assert e.dtype == np.float32 and np.all(np.diff(e) > 0)
    assert qs.qsketch_num_buckets(0.01, 1e-9, 1e9) == 4149 and qs.qsketch_num_buckets(0.1, 1e-6, 1e6) == 279
    for bad in ((1, 1e-9, 1e9), (0.01, 1.0, 1.0), (1.5, 1e-9, 1e9)):
        with pytest.raises(ValueError):
            qs.qsketch_num_buckets(*bad)


@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_qsketch_curve_and_rank_counts_equal_jax_off_the_edges(kind):
    grid = (0.01, 1e-6, 1e6)
    preds, target = _layout(kind, 6)
    preds = np.where(np.isnan(preds), np.nan, np.log(preds / (1 - preds))).astype(np.float32)  # logits
    keep = ~_near_edge(np.nan_to_num(preds), grid)
    keep = keep.all(axis=-1) if keep.ndim == 2 else keep
    preds, target = preds[keep], target[keep]
    spec = jqs.qsketch_curve_spec(grid[0], None if kind == "binary" else 4)
    want = jqs.qsketch_curve_update(jnp.zeros(spec.shape, jnp.int32), jnp.asarray(preds), jnp.asarray(target),
                                    *grid, 1)
    got = qs.qsketch_curve_update(torch.zeros(spec.shape, dtype=torch.int64), torch.from_numpy(preds),
                                  torch.from_numpy(target), *grid, 1)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    rng = np.random.default_rng(7)
    p = rng.lognormal(0.0, 2.0, 600).astype(np.float32)
    t = (p * rng.lognormal(0.0, 0.5, 600)).astype(np.float32)
    p[4], t[8] = np.nan, np.nan
    rgrid = jqs.QSKETCH_RANK_ALPHA, *jqs.QSKETCH_RANK_RANGE
    keep = ~_near_edge(np.nan_to_num(p), rgrid) & ~_near_edge(np.nan_to_num(t), rgrid)
    b = jqs.qsketch_num_buckets(*rgrid)
    want = jqs.qsketch_rank_update(jnp.zeros((b, b), jnp.int32), jnp.asarray(p[keep]), jnp.asarray(t[keep]), *rgrid)
    got = qs.qsketch_rank_update(torch.zeros(b, b, dtype=torch.int64), torch.from_numpy(p[keep]),
                                 torch.from_numpy(t[keep]), *rgrid)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------- curve math
def _hist(seed, shape, hi=50):
    return np.random.default_rng(seed).integers(0, hi, shape).astype(np.int64)


def _mann_whitney(pos, neg):
    """The exact AUROC of binned data in float64: P(s+ > s-) + P(s+ = s-) / 2."""
    below = np.concatenate([[0], np.cumsum(neg)[:-1]])
    return float(np.sum(pos * (below + neg / 2.0)) / (pos.sum() * neg.sum()))


@pytest.mark.parametrize("shape", [(2, 64), (3, 2, 16), (2, 2048)])
def test_curve_math_equals_jax_and_the_float64_oracle(shape):
    h = _hist(8, shape)
    h[..., 0, -1] += 7  # saturated top bin: the terminal point keeps its half credit
    t, j = torch.from_numpy(h), jnp.asarray(h.astype(np.int32))
    for name in ("auroc_from_histogram", "average_precision_from_histogram", "auroc_error_bound",
                 "curve_collision_bound"):
        got = getattr(sk, name)(t)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(getattr(jsk, name)(j)), rtol=RTOL_JAX, err_msg=name)
    for name in ("roc_from_histogram", "precision_recall_from_histogram", "curve_counts_from_histogram"):
        for g, w in zip(getattr(sk, name)(t), getattr(jsk, name)(j)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL_JAX, atol=1e-7, err_msg=name)
    flat = h.reshape(-1, 2, shape[-1])
    auroc = sk.auroc_from_histogram(t).reshape(-1).numpy()
    for c in range(flat.shape[0]):
        pos, neg = flat[c, 0].astype(np.float64), flat[c, 1].astype(np.float64)
        np.testing.assert_allclose(auroc[c], _mann_whitney(pos, neg), rtol=RTOL_ORACLE)
        np.testing.assert_allclose(sk.auroc_error_bound(t).reshape(-1)[c].item(),
                                   np.sum(pos * neg) / (2 * pos.sum() * neg.sum()), rtol=RTOL_ORACLE)


def test_auroc_error_bound_certifies_the_exact_auroc():
    rng = np.random.default_rng(9)
    target = rng.random(5_000) < 0.3
    scores = (1 / (1 + np.exp(-(rng.standard_normal(5_000) + 1.2 * target)))).astype(np.float32)
    counts = sk.sketch_curve_update(torch.zeros(2, 64, dtype=torch.int64), torch.from_numpy(scores),
                                    torch.from_numpy(target.astype(np.int64)), 0.0, 1.0, 1)
    ranks = scipy.stats.rankdata(scores)
    n_pos, n_neg = target.sum(), (~target).sum()
    exact = (ranks[target].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg)
    assert abs(float(sk.auroc_from_histogram(counts)) - exact) <= float(sk.auroc_error_bound(counts))
    assert float(sk.curve_collision_bound(counts)) == pytest.approx(2 * float(sk.auroc_error_bound(counts)))


# ----------------------------------------------------------------- rank math
@pytest.mark.parametrize("b", [8, 64])
def test_spearman_and_kendall_from_joint_equal_jax_and_scipy(b):
    rng = np.random.default_rng(10)
    bi = rng.integers(0, b, 3_000)
    bj = np.clip(bi + rng.integers(-3, 4, 3_000), 0, b - 1)
    h = np.zeros((b, b), np.int64)
    np.add.at(h, (bi, bj), 1)
    t, j = torch.from_numpy(h), jnp.asarray(h.astype(np.int32))
    for name, oracle in (("spearman_from_joint", scipy.stats.spearmanr(bi, bj)[0]),
                         ("kendall_from_joint", scipy.stats.kendalltau(bi, bj)[0])):
        got = float(getattr(sk, name)(t))
        np.testing.assert_allclose(got, float(getattr(jsk, name)(j)), rtol=RTOL_JAX, err_msg=name)
        np.testing.assert_allclose(got, oracle, rtol=RTOL_ORACLE, err_msg=name)
    np.testing.assert_allclose(float(sk.rank_collision_bound(t)), float(jsk.rank_collision_bound(j)), rtol=RTOL_JAX)
    empty = torch.zeros(b, b, dtype=torch.int64)
    assert np.isnan(float(sk.spearman_from_joint(empty))) and np.isnan(float(sk.kendall_from_joint(empty)))


def test_spearman_denominator_does_not_overflow_where_jax_returns_zero():
    rng = np.random.default_rng(0)
    h = rng.integers(0, 200_000, (8, 8)) + np.diag(rng.integers(0, 2_000_000, 8))  # 15.3M samples
    n = h.sum()
    mid = lambda m: np.cumsum(m) - m / 2.0 + 0.5 - (n + 1) / 2.0  # noqa: E731
    r, s = mid(h.sum(1).astype(np.float64)), mid(h.sum(0).astype(np.float64))
    oracle = np.sum(h * r[:, None] * s[None, :]) / np.sqrt(np.sum(h.sum(1) * r * r) * np.sum(h.sum(0) * s * s))
    assert float(jsk.spearman_from_joint(jnp.asarray(h.astype(np.int32)))) == 0.0  # var_x * var_y = inf in float32
    np.testing.assert_allclose(float(sk.spearman_from_joint(torch.from_numpy(h))), oracle, rtol=RTOL_ORACLE)


# ------------------------------------------------------------ metric modules
def _batches(kind, seed, sizes=(64, 40, 64), logits=False):
    out = []
    for i, n in enumerate(sizes):
        p, t = _layout(kind, seed + i, n=n)
        if logits:
            p = np.log(p / (1 - p)).astype(np.float32)
        out.append((p, t))
    return out


def _cycle(port, ref, batches):
    """forward each batch in both packages, compute, reset, one more forward: every value compared."""
    def close(g, w, what):
        if isinstance(g, (list, tuple)):
            for a, b in zip(g, w):
                close(a, b, what)
            return
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=RTOL_JAX, atol=1e-6, err_msg=what)

    for i, (p, t) in enumerate(batches):
        close(port(torch.from_numpy(p), torch.from_numpy(t)), ref(jnp.asarray(p), jnp.asarray(t)), f"step {i}")
    close(port.compute(), ref.compute(), "epoch")
    np.testing.assert_array_equal(port.hist.counts.numpy() if hasattr(port, "hist") else port.joint.counts.numpy(),
                                  np.asarray(ref.hist.counts if hasattr(ref, "hist") else ref.joint.counts))
    port.reset()
    ref.reset()
    p, t = batches[0]
    close(port(torch.from_numpy(p), torch.from_numpy(t)), ref(jnp.asarray(p), jnp.asarray(t)), "after reset")


@pytest.mark.parametrize("name", ["AUROC", "AveragePrecision", "ROC", "PrecisionRecallCurve"])
@pytest.mark.parametrize("kind", ["binary", "multiclass", "multilabel"])
def test_curve_sketch_modules_equal_jax(name, kind):
    if kind == "multilabel" and name in ("AveragePrecision", "PrecisionRecallCurve", "ROC"):
        kw = {"num_classes": 4, "pos_label": 1}
    else:
        kw = {} if kind == "binary" else {"num_classes": 4}
    _cycle(getattr(pt, name)(approx="sketch", num_bins=128, device="cpu", **kw),
           getattr(mt, name)(approx="sketch", num_bins=128, **kw), _batches(kind, 20))


@pytest.mark.parametrize("average", ["macro", "weighted", "micro", None])
def test_auroc_sketch_averages_equal_jax(average):
    _cycle(pt.AUROC(approx="sketch", num_classes=4, average=average, num_bins=64, device="cpu"),
           mt.AUROC(approx="sketch", num_classes=4, average=average, num_bins=64), _batches("multiclass", 30))


@pytest.mark.parametrize("name", ["AUROC", "AveragePrecision"])
@pytest.mark.parametrize("kind", ["binary", "multiclass"])
def test_curve_qsketch_modules_equal_jax(name, kind):
    kw = {} if kind == "binary" else {"num_classes": 4}
    port, ref = getattr(pt, name)(approx="qsketch", device="cpu", **kw), getattr(mt, name)(approx="qsketch", **kw)
    _cycle(port, ref, _batches(kind, 40, logits=True))
    bound = "error_bound" if name == "AUROC" else "collision_bound"
    np.testing.assert_allclose(getattr(port, bound)().numpy(), np.asarray(getattr(ref, bound)()), rtol=RTOL_JAX)


@pytest.mark.parametrize("name", ["SpearmanCorrcoef", "KendallRankCorrCoef"])
@pytest.mark.parametrize("approx,grid", [("sketch", None), ("sketch", (0.0, 8.0)), ("qsketch", None)])
def test_rank_sketch_modules_equal_jax(name, approx, grid):
    rng = np.random.default_rng(50)
    batches = []
    for n in (64, 40, 64):
        t = rng.lognormal(0.0, 1.0, n).astype(np.float32)
        batches.append(((t * np.exp(0.3 * rng.standard_normal(n))).astype(np.float32), t))
    port = getattr(pt, name)(approx=approx, sketch_range=grid, device="cpu")
    ref = getattr(mt, name)(approx=approx, sketch_range=grid)
    _cycle(port, ref, batches)
    np.testing.assert_allclose(float(port.collision_bound()), float(ref.collision_bound()), rtol=RTOL_JAX)


def test_sketch_compute_groups_span_classes_and_update_once_a_step():
    col = pt.MetricCollection([
        pt.AUROC(approx="sketch", device="cpu"), pt.AveragePrecision(approx="sketch", device="cpu"),
        pt.ROC(approx="sketch", device="cpu"), pt.PrecisionRecallCurve(approx="sketch", device="cpu"),
        pt.SpearmanCorrcoef(approx="sketch", device="cpu"), pt.KendallRankCorrCoef(approx="sketch", device="cpu"),
    ])
    groups = col.compute_groups
    assert groups == {"AUROC": ("AUROC", "AveragePrecision", "ROC", "PrecisionRecallCurve"),
                      "SpearmanCorrcoef": ("SpearmanCorrcoef", "KendallRankCorrCoef")}
    qcol = pt.MetricCollection({
        "auroc": pt.AUROC(approx="qsketch", device="cpu"), "ap": pt.AveragePrecision(approx="qsketch", device="cpu"),
        "ap_bins": pt.AveragePrecision(approx="sketch", num_bins=64, device="cpu"),
        "auroc_pos0": pt.AUROC(approx="qsketch", pos_label=0, device="cpu"),
    })
    assert sorted(qcol.compute_groups.values()) == [("ap_bins",), ("auroc", "ap"), ("auroc_pos0",)]
    jcol = mt.MetricCollection({"auroc": mt.AUROC(approx="qsketch"), "ap": mt.AveragePrecision(approx="qsketch"),
                                "ap_bins": mt.AveragePrecision(approx="sketch", num_bins=64),
                                "auroc_pos0": mt.AUROC(approx="qsketch", pos_label=0)})
    assert sorted(jcol.compute_groups.values()) == sorted(qcol.compute_groups.values())
    calls = []
    real = Metric._run_update_on_state
    Metric._run_update_on_state = lambda self, *a, **k: (calls.append(type(self).__name__), real(self, *a, **k))[1]
    try:
        p, t = _layout("binary", 60)
        col(torch.from_numpy(p), torch.from_numpy(t.astype(np.float32)))
    finally:
        Metric._run_update_on_state = real
    assert calls == ["AUROC", "SpearmanCorrcoef"]
    assert torch.equal(col["ROC"].hist.counts, col["AUROC"].hist.counts)


def test_constructor_and_layout_errors_equal_jax():
    def same(port_fn, ref_fn):
        with pytest.raises(Exception) as ref_err:
            ref_fn()
        with pytest.raises(type(ref_err.value)) as port_err:
            port_fn()
        assert str(port_err.value) == str(ref_err.value)

    same(lambda: pt.AUROC(approx="sketch", max_fpr=0.5, device="cpu"), lambda: mt.AUROC(approx="sketch", max_fpr=0.5))
    same(lambda: pt.ROC(approx="qsketch", device="cpu"), lambda: mt.ROC(approx="qsketch"))
    same(lambda: pt.AUROC(approx="sketch", num_bins=1, device="cpu"), lambda: mt.AUROC(approx="sketch", num_bins=1))
    same(lambda: pt.AUROC(approx="sketch", sketch_range=(1.0, 0.0), device="cpu"),
         lambda: mt.AUROC(approx="sketch", sketch_range=(1.0, 0.0)))
    same(lambda: pt.SpearmanCorrcoef(approx="qsketch", sketch_range=(0.0, 1.0), device="cpu"),
         lambda: mt.SpearmanCorrcoef(approx="qsketch", sketch_range=(0.0, 1.0)))
    same(lambda: pt.KendallRankCorrCoef(approx="qsketch", alpha=0.001, device="cpu"),
         lambda: mt.KendallRankCorrCoef(approx="qsketch", alpha=0.001))
    p2, t2 = _layout("multiclass", 3, n=8)
    p1, t1 = _layout("binary", 3, n=8)
    for approx in ("sketch", "qsketch"):
        same(lambda: pt.AUROC(approx=approx, device="cpu").update(torch.from_numpy(p2), torch.from_numpy(t2)),
             lambda: mt.AUROC(approx=approx).update(jnp.asarray(p2), jnp.asarray(t2)))
        same(lambda: pt.AUROC(approx=approx, num_classes=4, device="cpu").update(torch.from_numpy(p1),
                                                                                  torch.from_numpy(t1)),
             lambda: mt.AUROC(approx=approx, num_classes=4).update(jnp.asarray(p1), jnp.asarray(t1)))
    for name in ("error_bound",):
        same(lambda: getattr(pt.AUROC(device="cpu"), name)(), lambda: getattr(mt.AUROC(), name)())
    same(lambda: pt.SpearmanCorrcoef(device="cpu").collision_bound(), lambda: mt.SpearmanCorrcoef().collision_bound())


class _PortSketch(Metric):
    def __init__(self, fx):
        super().__init__(device="cpu")
        self.add_state("hist", default=sk.curve_sketch_spec(8, None, 0.0, 1.0), dist_reduce_fx=fx)

    def update(self):
        pass

    def compute(self):
        return 0


class _JaxSketch(JaxMetric):
    def __init__(self, fx):
        super().__init__()
        self.add_state("hist", default=jsk.curve_sketch_spec(8, None, 0.0, 1.0), dist_reduce_fx=fx)

    def update(self):
        pass

    def compute(self):
        return 0


@pytest.mark.parametrize("fx", ["cat", "max", None])
def test_add_state_requires_sum_with_the_jax_message(fx):
    with pytest.raises(ValueError) as ref_err:
        _JaxSketch(fx)
    with pytest.raises(ValueError, match="sum-mergeable by construction") as port_err:
        _PortSketch(fx)
    assert str(port_err.value) == str(ref_err.value)
    assert isinstance(_PortSketch("sum").hist, sk.HistogramSketch)


_CHECKPOINTED = [
    ("AUROC", {"approx": "sketch", "num_bins": 32}, "binary"),
    ("AUROC", {"approx": "qsketch", "num_classes": 4}, "multiclass"),
    ("ROC", {"approx": "sketch", "num_bins": 16}, "binary"),
    ("SpearmanCorrcoef", {"approx": "sketch"}, "pairs"),
    ("KendallRankCorrCoef", {"approx": "qsketch"}, "pairs"),
]


@pytest.mark.parametrize("name,kw,kind", _CHECKPOINTED)
def test_jax_checkpoint_of_each_sketch_kind_loads_into_the_port(name, kw, kind):
    if kind == "pairs":
        rng = np.random.default_rng(70)
        t = rng.lognormal(0.0, 1.0, 200).astype(np.float32)
        p, y = (t * rng.lognormal(0.0, 0.3, 200)).astype(np.float32), t
    else:
        p, y = _layout(kind, 70)
        if kw["approx"] == "qsketch":
            p = np.log(p / (1 - p)).astype(np.float32)
    ref = getattr(mt, name)(**kw)
    ref.update(jnp.asarray(p), jnp.asarray(y))
    ref.persistent(True)
    state = ref.state_dict()
    key = "hist" if "hist" in state else "joint"
    assert set(state[key]) == {"sketch_counts"} and state[key]["sketch_counts"].dtype == np.int32
    port = getattr(pt, name)(device="cpu", **kw)
    port.load_state_dict(state)
    counts = getattr(port, key).counts
    assert counts.dtype == torch.int64 and type(getattr(port, key)).__name__ == type(getattr(ref, key)).__name__
    np.testing.assert_array_equal(counts.numpy(), np.asarray(getattr(ref, key).counts))
    for g, w in zip(np.atleast_1d(port.compute() if name != "ROC" else port.compute()[1]),
                    np.atleast_1d(ref.compute() if name != "ROC" else ref.compute()[1])):
        np.testing.assert_allclose(_np(g), np.asarray(w), rtol=RTOL_JAX, atol=1e-7)
    port.persistent(True)
    back = getattr(mt, name)(**kw)
    back.load_state_dict(port.state_dict())
    np.testing.assert_array_equal(np.asarray(getattr(back, key).counts), counts.numpy())


def test_jax_collection_checkpoint_with_a_sketch_group_loads_into_the_port():
    p, t = _layout("binary", 80)
    ref = mt.MetricCollection([mt.AUROC(approx="sketch"), mt.AveragePrecision(approx="sketch")])
    ref.update(jnp.asarray(p), jnp.asarray(t))
    ref.persistent(True)
    state = ref.state_dict()
    assert state["_compute_group_manifest"] == {"AveragePrecision": "AUROC"}
    port = pt.MetricCollection([pt.AUROC(approx="sketch", device="cpu"),
                                pt.AveragePrecision(approx="sketch", device="cpu")])
    port.load_state_dict(state)
    for k, v in port.compute().items():
        np.testing.assert_allclose(float(v), float(ref.compute()[k]), rtol=RTOL_JAX)
    port.persistent(True)
    assert port.state_dict()["_compute_group_manifest"] == {"AveragePrecision": "AUROC"}


def test_reset_deepcopy_pickle_and_merge_arms():
    p, t = _layout("binary", 90)
    m = pt.AUROC(approx="sketch", num_bins=32, device="cpu")
    m.update(torch.from_numpy(p[:100]), torch.from_numpy(t[:100]))
    for other in (copy.deepcopy(m), pickle.loads(pickle.dumps(m))):
        assert isinstance(other.hist, sk.HistogramSketch) and torch.equal(other.hist.counts, m.hist.counts)
        other.update(torch.from_numpy(p[100:]), torch.from_numpy(t[100:]))
        assert float(other.compute()) == pytest.approx(float(pt.AUROC(approx="sketch", num_bins=32, device="cpu")(
            torch.from_numpy(p), torch.from_numpy(t))), rel=1e-6)
    m.reset()
    assert int(m.hist.counts.sum()) == 0 and m.hist.counts.dtype == torch.int64
    a, b = sk.HistogramSketch(torch.ones(2, 4, dtype=torch.int64)), sk.HistogramSketch(torch.full((2, 4), 2))
    assert torch.equal(merge_values("sum", a, b).counts, torch.full((2, 4), 3)) and is_mergeable("sum", a)
    with pytest.raises(TypeError, match="cannot merge sketch kinds"):
        sk.sketch_merge(a, sk.RankSketch(torch.ones(4, 4, dtype=torch.int64)))
    assert sk.sketch_nbytes(a) == 64
    # a host-gather sync (a dist_sync_fn) sums the ranks' counts and keeps the kind
    synced = host_gather({"hist": a}, {"hist": "sum"}, lambda x: [x, 2 * x])
    assert isinstance(synced["hist"], sk.HistogramSketch) and torch.equal(synced["hist"].counts, 3 * a.counts)
