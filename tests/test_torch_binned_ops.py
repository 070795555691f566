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
from metrics_tpu_torch.ops.binned import binned_counts_cuda, binned_stat_counts, rank_thresholds

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



# --------------------------------------------------------------------------------------------
# The kernel's algorithm on the CPU. The CUDA kernel itself runs only on the card; what it
# computes is mirrored here step by step in torch (ranked grid, bucket table, bracket search,
# histogram, suffix sum, scatter through the permutation) and held to the plain version and
# to the JAX package, bit for bit with bool weights.

_F32 = np.float32


def _adversarial_grid():
    """Unsorted, duplicates, -0.0 beside +0.0, +-inf, a subnormal and NaN."""
    sub = np.float32(np.finfo(np.float32).smallest_subnormal)
    return np.asarray([0.7, -0.0, 0.25, 0.0, np.inf, 0.25, -np.inf, np.nan, sub, -sub, 1.0, 0.7, np.nan, 0.5,
                       -3.5, 1e30, -1e-30], dtype=_F32)


_GRIDS = {
    "linspace": lambda: np.linspace(0.0, 1.0, 33, dtype=_F32),
    "unsorted": lambda: np.random.RandomState(0).rand(40).astype(_F32),
    "duplicates": lambda: np.asarray([0.5, 0.1, 0.5, 0.9, 0.1, 0.5], dtype=_F32),
    "adversarial": _adversarial_grid,
    "all_nan": lambda: np.full(4, np.nan, dtype=_F32),
    "one_value": lambda: np.full(5, 0.25, dtype=_F32),
    "only_inf": lambda: np.asarray([np.inf, -np.inf, np.inf], dtype=_F32),
}


def _adversarial_scores(grid):
    """Every threshold, its nextafter neighbours, -0.0, subnormals, +-inf and NaN."""
    finite = grid[np.isfinite(grid)]
    sub = np.float32(np.finfo(np.float32).smallest_subnormal)
    extra = np.asarray([0.0, -0.0, sub, -sub, 2 * sub, np.inf, -np.inf, np.nan, 0.3, -7.0, 3e38], dtype=_F32)
    return np.concatenate([grid, np.nextafter(finite, _F32(np.inf)), np.nextafter(finite, _F32(-np.inf)),
                           extra]).astype(_F32)


def _bucket(x, lo, inv_w, m):
    """The kernel's bucket(): round-to-nearest float32 (x - lo) * inv_w, truncated, clamped to [0, m)."""
    y = (x - lo) * inv_w
    b = torch.where(y < m - 1, torch.nan_to_num(y, nan=0.0, posinf=0.0, neginf=0.0).trunc(),
                    torch.full_like(y, m - 1))
    return torch.where(y > 0, b, torch.zeros_like(y)).to(torch.int64)


def _bucket_table(sorted_thr, m):
    """The table each block builds: ``(tab, lo, inv_w)`` with tab[b] = #{k : bucket(s[k]) < b}."""
    s = sorted_thr
    tf = int((~torch.isnan(s)).sum())
    finite = s[torch.isfinite(s)]
    lo = finite[0] if finite.numel() else torch.tensor(0.0)
    hi = finite[-1] if finite.numel() else torch.tensor(0.0)
    span = hi - lo
    inv_w = torch.tensor(float(m), dtype=torch.float32) / span if span > 0 else torch.tensor(0.0)
    if not torch.isfinite(inv_w):
        inv_w = torch.tensor(0.0)
    tab = torch.zeros(m + 1, dtype=torch.int64)
    g = _bucket(s[:tf], lo, inv_w, m).tolist() + [m]
    for k in range(tf + 1):  # threshold k owns buckets bucket(s[k - 1]) .. bucket(s[k]) - 1
        for b in range(g[k - 1] if k > 0 else 0, g[k]):
            tab[b + 1] = k
    return tab, lo, inv_w


def _kernel_bins(sorted_thr, scores, m):
    """Table start, then the count of s[k] <= p inside the bracket [tab[b], tab[b + 1])."""
    tab, lo, inv_w = _bucket_table(sorted_thr, m)
    b = _bucket(scores, lo, inv_w, m)
    left, right = tab[b], tab[b + 1]
    k = torch.arange(sorted_thr.shape[0])
    inside = (k[None, :] >= left[:, None]) & (k[None, :] < right[:, None])
    return left + (inside & (sorted_thr[None, :] <= scores[:, None])).sum(1), right - left


def _kernel_counts(preds, pos, neg, thr, m=None):
    """The whole kernel in torch: ranked grid -> bins -> bincount -> reverse cumsum -> scatter."""
    p, thr_t = torch.from_numpy(preds), torch.from_numpy(thr)
    t = thr_t.shape[0]
    sorted_thr, perm = rank_thresholds(thr_t)
    bins, _ = _kernel_bins(sorted_thr, p, 2 * t if m is None else m)
    out = []
    for w in (torch.from_numpy(pos), torch.from_numpy(neg)):
        hist = torch.bincount(bins, weights=w.to(torch.float64), minlength=t + 1)
        suffix = hist.flip(0).cumsum(0).flip(0)  # suffix[j] = sum of bins j..t
        counts = torch.empty(t, dtype=torch.float32)
        counts[perm.long()] = suffix[1:].to(torch.float32)
        out.append(counts.numpy()[None, :])
    return tuple(out)


@pytest.mark.parametrize("grid", sorted(_GRIDS))
def test_rank_thresholds_is_numpy_lexsort_nan_last(grid):
    thr = _GRIDS[grid]()
    sorted_thr, perm = rank_thresholds(torch.from_numpy(thr))
    order = np.lexsort((np.arange(thr.shape[0]), thr))  # by value (NaN last), ties by index
    assert perm.dtype == torch.int32 and sorted_thr.dtype == torch.float32
    np.testing.assert_array_equal(perm.numpy(), order)
    assert sorted_thr.numpy().tobytes() == thr[order].tobytes()  # -0.0 keeps its sign


@pytest.mark.parametrize("m_of_t", [lambda t: 2 * t, lambda t: 1, lambda t: 7])
@pytest.mark.parametrize("grid", sorted(_GRIDS))
def test_bucket_table_walk_equals_searchsorted(grid, m_of_t):
    thr = _GRIDS[grid]()
    sorted_thr, _ = rank_thresholds(torch.from_numpy(thr))
    scores = torch.from_numpy(_adversarial_scores(thr))
    bins, width = _kernel_bins(sorted_thr, scores, m_of_t(thr.shape[0]))
    nan = torch.isnan(scores)
    # #{k : s[k] <= p}: NaN thresholds (ranked last) reach no score, so search the rest
    want = torch.searchsorted(sorted_thr[~torch.isnan(sorted_thr)], scores, right=True)
    np.testing.assert_array_equal(bins[~nan].numpy(), want[~nan].numpy())
    assert (bins[nan] == 0).all()  # a NaN score reaches no threshold
    if grid == "linspace" and m_of_t(33) == 66:
        assert int(width.max()) <= 2  # an even grid leaves at most two comparisons a score


def _grid_case(n, t, grid, subnormals=True):
    preds, pos, neg, thr = _inputs(n, 1, t, seed=n + t, sort=False)
    if grid is None:
        return preds, pos, neg, thr
    thr = _GRIDS[grid]()
    preds = np.concatenate([_adversarial_scores(thr), preds[:, 0]]).astype(_F32)
    if not subnormals:
        tiny = np.finfo(np.float32).tiny
        thr = thr[~((thr != 0) & (np.abs(thr) < tiny))]
        preds = preds[~((preds != 0) & (np.abs(preds) < tiny))]
    pos = np.random.RandomState(n).rand(preds.shape[0], 1) > 0.5
    return preds[:, None], pos, ~pos, thr


@pytest.mark.parametrize("impl", ["xla", "pallas_interpret"])
@pytest.mark.parametrize("n,t,grid", [(37, 5, None), (2049, 64, None), (5000, 129, "unsorted"),
                                      (300, 17, "adversarial"), (64, 6, "duplicates")])
def test_kernel_algorithm_is_bit_exact(n, t, grid, impl):
    """Against the JAX package. XLA on the CPU flushes subnormals to zero, so the grids and
    scores here leave them out; the next test holds them to the plain version and numpy."""
    preds, pos, neg, thr = _grid_case(n, t, grid, subnormals=False)
    got = _kernel_counts(preds[:, 0], pos[:, 0], neg[:, 0], thr)
    for g, plain, ref in zip(got, _port(preds, pos, neg, thr), _jax(preds, pos, neg, thr, impl)):
        np.testing.assert_array_equal(g, plain)
        np.testing.assert_array_equal(g, ref)


@pytest.mark.parametrize("grid", ["adversarial", "only_inf", "one_value", "all_nan"])
def test_kernel_algorithm_with_subnormals_is_bit_exact(grid):
    """IEEE comparisons, subnormals included: the emulation, the plain version and a numpy
    count of ``p >= thr`` over the non-NaN scores agree exactly."""
    preds, pos, neg, thr = _grid_case(300, 0, grid)
    got = _kernel_counts(preds[:, 0], pos[:, 0], neg[:, 0], thr)
    ge = preds[:, 0][:, None] >= thr[None, :]  # NaN on either side compares false
    for g, plain, w in zip(got, _port(preds, pos, neg, thr), (pos[:, 0], neg[:, 0])):
        np.testing.assert_array_equal(g, plain)
        np.testing.assert_array_equal(g[0], (ge & w[:, None]).sum(0).astype(np.float32))


def test_binned_metrics_pass_the_ranked_grid_and_rerank_after_to(monkeypatch):
    import metrics_tpu_torch.classification.binned as port_binned
    import metrics_tpu_torch.functional.classification.binned_curves as port_fn

    seen = []
    real = port_fn.binned_stat_counts

    def spy(*args, **kwargs):
        seen.append(kwargs.get("ranked"))
        return real(*args, **kwargs)

    monkeypatch.setattr(port_fn, "binned_stat_counts", spy)
    m = port_binned.BinnedAUROC(thresholds=[0.9, 0.1, 0.5, 0.5, float("nan"), 0.3], device="cpu")
    preds, target = torch.rand(50, generator=torch.Generator().manual_seed(0)), torch.arange(50) % 2
    m.update(preds, target)
    m.update(preds, target)
    assert len(seen) == 2 and seen[0] is not None and seen[1] is seen[0]  # ranked once, not per update
    want = [x.numpy().tobytes() for x in rank_thresholds(m.thresholds)]  # bytes: NaN equals NaN
    assert [x.numpy().tobytes() for x in seen[0]] == want
    m.to(torch.device("cpu"))
    m.update(preds, target)
    assert seen[2] is not seen[0] and [x.numpy().tobytes() for x in seen[2]] == want
    assert seen[2][0].device == m.thresholds.device
