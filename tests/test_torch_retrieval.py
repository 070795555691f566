"""Retrieval: the port against the JAX package, with the Dice and empty-AP repairs.

The same numpy inputs (from a seed) go through ``metrics_tpu`` and
``metrics_tpu_torch`` (``device="cpu"``): the grouped segment functions, the
single-query functionals, and the eight modules over several batches (tied
scores on a 1/8 grid, NaN scores, ``-100`` exclude sentinels, graded targets,
queries without a relevant row and queries split across batches), under the
four empty-query policies, in list and ``capacity`` modes and in one
``MetricCollection``. Also ``get_group_indexes``, the exclusion form of the
compute-group key on a toy class, ``Dice`` and empty-input ``average_precision``.

Tolerances: ranks, counts and hits are integers and must be equal. Per-query
float values divide those integers once in float32 (equal), or sum a few float32
terms per query (AP contributions, NDCG gains) in another order or width: the
port adds them exactly in float64 and rounds once, the JAX package adds in
float32, so rtol 1e-6. A module's value is a float32 mean over the queries in
another order: rtol 1e-6.

One case shows a fault of the JAX package that the port does not copy: its
within-query relevance counts come from a float32 global ``cumsum``, wrong past
2**24 relevant rows.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt
import metrics_tpu.functional as mtf
import metrics_tpu.functional.retrieval as mtr
import metrics_tpu_torch as pt
import metrics_tpu_torch.functional as ptf
import metrics_tpu_torch.functional.retrieval as ptr
from metrics_tpu.core.metric import Metric as JaxMetric
from metrics_tpu.utils.data import get_group_indexes as jax_get_group_indexes
from metrics_tpu_torch.core.metric import Metric as TorchMetric
from metrics_tpu_torch.utils.data import get_group_indexes

torch.set_num_threads(1)

_RTOL = 1e-6
_MODULES = ("RetrievalMAP", "RetrievalMRR", "RetrievalPrecision", "RetrievalRecall", "RetrievalFallOut",
            "RetrievalHitRate", "RetrievalRPrecision", "RetrievalNormalizedDCG")
_AT_K = ("RetrievalPrecision", "RetrievalRecall", "RetrievalFallOut", "RetrievalHitRate", "RetrievalNormalizedDCG")


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def _rows(seed, n_queries=12, exclude=True, nan=True):
    """(idx, preds, target) over queries of 1-9 rows in shuffled order: sparse query ids,
    scores on a 1/8 grid (ties), a few NaN scores, graded targets 0-3 with some
    queries holding no relevant row, and a few -100 sentinels."""
    rng = np.random.RandomState(seed)
    qids = rng.permutation(np.unique(rng.randint(0, 2**31 - 1, 4 * n_queries)))[:n_queries]
    sizes = rng.randint(1, 10, n_queries)
    idx = np.repeat(qids, sizes).astype(np.int64)
    n = idx.size
    target = np.where(rng.rand(n) < 0.35, rng.randint(1, 4, n), 0)
    target[np.isin(idx, qids[:3])] = 0  # three queries with no relevant row
    if exclude:
        target[rng.rand(n) < 0.08] = -100
    preds = (np.round(rng.rand(n) * 8) / 8).astype(np.float32)
    if nan:
        preds[rng.rand(n) < 0.05] = np.nan
    perm = rng.permutation(n)
    return idx[perm], preds[perm], target[perm].astype(np.int64)


def _dense(idx):
    return np.unique(idx, return_inverse=True)[1].astype(np.int64)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


def _assert_same(got, want, integer=False):
    got, want = _np(got), _np(want)
    if integer:
        np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))
    else:
        np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=_RTOL, atol=0)


# --------------------------------------------------------------- segment functions
def test_sort_positions_and_cumsum_equal_jax():
    idx, preds, target = _rows(1)
    d = _dense(idx)
    rel = (target > 0).astype(np.float32)
    jd, jp, jt = mtr.sort_by_query_then_score(jnp.asarray(d, jnp.int32), jnp.asarray(preds), jnp.asarray(rel))
    td, tp, tt = ptr.sort_by_query_then_score(torch.from_numpy(d), torch.from_numpy(preds), torch.from_numpy(rel))
    _assert_same(td, jd, integer=True)
    np.testing.assert_array_equal(_np(tp), _np(jp))  # the same rows in the same order: NaN last, ties by row
    _assert_same(tt, jt, integer=True)
    n = len(d)
    (jr, jc), (tr, tc) = mtr.segment_positions(jd, n), ptr.segment_positions(td, n)
    _assert_same(tr, jr, integer=True)
    _assert_same(tc, jc, integer=True)
    _assert_same(ptr.within_segment_cumsum(tt.to(torch.int64), td, n), mtr.within_segment_cumsum(jt, jd, n),
                 integer=True)
    # a float input is scanned in float64 and comes back in its own dtype
    scan = ptr.within_segment_cumsum(tt, td, n)
    assert scan.dtype == torch.float32
    _assert_same(scan, mtr.within_segment_cumsum(jt, jd, n), integer=True)


_GROUPED = [
    ("ap", lambda m, d, p, t, n, v: m.grouped_average_precision(d, p, t > 0, n)),
    ("rr", lambda m, d, p, t, n, v: m.grouped_reciprocal_rank(d, p, t, n)),
    ("hits", lambda m, d, p, t, n, v: m.grouped_topk_hits(d, p, t, n, None, v)),
    ("hits@3", lambda m, d, p, t, n, v: m.grouped_topk_hits(d, p, t, n, 3, v)),
    ("hit_rate@2", lambda m, d, p, t, n, v: m.grouped_hit_rate(d, p, t, n, 2, v)),
    ("fall_out", lambda m, d, p, t, n, v: m.grouped_fall_out(d, p, t, n, None, v)),
    ("fall_out@2", lambda m, d, p, t, n, v: m.grouped_fall_out(d, p, t, n, 2, v)),
    ("r_precision", lambda m, d, p, t, n, v: m.grouped_r_precision(d, p, t, n)),
    ("ndcg", lambda m, d, p, t, n, v: m.grouped_ndcg(d, p, t, n)),
    ("ndcg@3", lambda m, d, p, t, n, v: m.grouped_ndcg(d, p, t, n, k=3)),
]


@pytest.mark.parametrize("name,fn", _GROUPED, ids=[g[0] for g in _GROUPED])
@pytest.mark.parametrize("seed", [2, 3])
def test_grouped_function_equals_jax(name, fn, seed):
    idx, preds, target = _rows(seed, exclude=False)
    d = _dense(idx)
    valid = np.random.RandomState(seed).rand(len(d)) > 0.1
    n = len(d)
    want = fn(mtr, jnp.asarray(d, jnp.int32), jnp.asarray(preds), jnp.asarray(target, jnp.int32), n, jnp.asarray(valid))
    got = fn(ptr, torch.from_numpy(d), torch.from_numpy(preds), torch.from_numpy(target), n, torch.from_numpy(valid))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        _assert_same(g, w, integer=not g.is_floating_point())


def test_first_relevant_rank_is_the_reciprocal_of_rr():
    idx, preds, target = _rows(4, exclude=False)
    d = torch.from_numpy(_dense(idx))
    first = ptr.segments.first_relevant_rank(d, torch.from_numpy(preds), torch.from_numpy(target), len(d))
    rr = ptr.grouped_reciprocal_rank(d, torch.from_numpy(preds), torch.from_numpy(target), len(d))
    assert first.dtype == torch.int64
    torch.testing.assert_close(torch.where(first > 0, 1.0 / first.clamp(min=1).float(), 0.0), rr, rtol=0, atol=0)


def test_relevance_counts_stay_exact_past_2_24_where_jax_drifts():
    """One query of 2**24 + 56 relevant rows, then a query of 8 rows with every other
    one relevant and descending scores: its within-query relevance counts are
    1, 1, 2, 2, 3, 3, 4, 4 and its AP (1 + 2/3 + 3/5 + 4/7) / 4 = 0.7095. The JAX
    package's float32 global cumsum minus float32 offsets is off by dozens there,
    and its AP for that query passes 23."""
    n0 = 2**24 + 56
    d = np.concatenate([np.zeros(n0, np.int32), np.ones(8, np.int32)])
    rel = np.concatenate([np.ones(n0, bool), np.tile([True, False], 4)])
    preds = np.concatenate([np.ones(n0, np.float32), np.linspace(1, 0, 8, dtype=np.float32)])
    right_counts = np.array([1, 1, 2, 2, 3, 3, 4, 4])
    right_ap = (1 + 2 / 3 + 3 / 5 + 4 / 7) / 4

    jax_counts = np.asarray(mtr.within_segment_cumsum(jnp.asarray(rel, jnp.float32), jnp.asarray(d), 2))[-8:]
    jax_ap = np.asarray(mtr.grouped_average_precision(jnp.asarray(d), jnp.asarray(preds), jnp.asarray(rel), 2)[0])
    assert not np.array_equal(jax_counts, right_counts) and jax_counts[0] >= 50
    assert jax_ap[1] > 23

    td = torch.from_numpy(d).to(torch.int64)
    counts = ptr.within_segment_cumsum(torch.from_numpy(rel), td, 2)[-8:]
    ap, rel_counts = ptr.grouped_average_precision(td, torch.from_numpy(preds), torch.from_numpy(rel), 2)
    np.testing.assert_array_equal(counts.numpy(), right_counts)
    assert rel_counts.tolist() == [n0, 4]
    np.testing.assert_allclose(ap.numpy(), [1.0, right_ap], rtol=_RTOL)


# ----------------------------------------------------------- single-query functionals
_SINGLE = [
    ("retrieval_average_precision", {}),
    ("retrieval_reciprocal_rank", {}),
    ("retrieval_precision", {}),
    ("retrieval_precision", {"k": 3}),
    ("retrieval_recall", {"k": 2}),
    ("retrieval_fall_out", {"k": 2}),
    ("retrieval_fall_out", {}),
    ("retrieval_hit_rate", {"k": 1}),
    ("retrieval_r_precision", {}),
    ("retrieval_normalized_dcg", {}),
    ("retrieval_normalized_dcg", {"k": 20}),
]


@pytest.mark.parametrize("name,kw", _SINGLE, ids=[f"{n}{kw}" for n, kw in _SINGLE])
def test_single_query_functional_equals_jax(name, kw):
    rng = np.random.RandomState(5)
    for n in (1, 4, 9):
        for _ in range(4):
            preds = (np.round(rng.rand(n) * 4) / 4).astype(np.float32)
            preds[rng.rand(n) < 0.1] = np.nan
            target = np.where(rng.rand(n) < 0.4, rng.randint(1, 4, n), 0)
            if name in ("retrieval_average_precision", "retrieval_precision", "retrieval_recall"):
                target = target > 0  # bool relevance, as their callers pass
            want = getattr(mtf, name)(jnp.asarray(preds), jnp.asarray(target), **kw)
            got = getattr(ptf, name)(torch.from_numpy(preds), torch.from_numpy(target), **kw)
            _assert_same(got, want)


@pytest.mark.parametrize("name", ["retrieval_precision", "retrieval_recall", "retrieval_fall_out",
                                  "retrieval_hit_rate", "retrieval_normalized_dcg"])
@pytest.mark.parametrize("k", [0, -1, 1.5])
def test_single_query_k_validation_matches_jax(name, k):
    p, t = np.array([0.1, 0.4], np.float32), np.array([1, 0])
    with pytest.raises(ValueError, match="`k` has to be a positive integer or None"):
        getattr(mtf, name)(jnp.asarray(p), jnp.asarray(t), k=k)
    with pytest.raises(ValueError, match="`k` has to be a positive integer or None"):
        getattr(ptf, name)(torch.from_numpy(p), torch.from_numpy(t), k=k)


@pytest.mark.parametrize("name", ["retrieval_average_precision", "retrieval_reciprocal_rank", "retrieval_r_precision"])
def test_single_query_input_checks_match_jax(name):
    p = np.array([0.1, 0.4], np.float32)
    for target, match in ((np.array([1, 0, 1]), "same shape"), (np.array([1.0, 0.0], np.float32), "booleans or integers")):
        with pytest.raises(ValueError, match=match):
            getattr(mtf, name)(jnp.asarray(p), jnp.asarray(target))
        with pytest.raises(ValueError, match=match):
            getattr(ptf, name)(torch.from_numpy(p), torch.from_numpy(target))


# ------------------------------------------------------------------------ modules
def _pair(name, capacity=None, **kw):
    jax_kw = dict(kw, jit=False)
    torch_kw = dict(kw, device="cpu")
    if capacity is not None:
        jax_kw["capacity"] = torch_kw["capacity"] = capacity
    return getattr(mt, name)(**jax_kw), getattr(pt, name)(**torch_kw)


def _batches(seed, n_batches=3):
    """One epoch cut into uneven batches, so queries straddle batch boundaries."""
    idx, preds, target = _rows(seed, n_queries=10)
    cuts = np.sort(np.random.RandomState(seed).choice(np.arange(1, len(idx)), n_batches - 1, replace=False))
    return list(zip(np.split(idx, cuts), np.split(preds, cuts), np.split(target, cuts)))


def _run(jm, tm, batches):
    for i, p, t in batches:
        want = jm(jnp.asarray(i), jnp.asarray(p), jnp.asarray(t))
        got = tm(torch.from_numpy(i), torch.from_numpy(p), torch.from_numpy(t))
        _assert_same(got, want)
    _assert_same(tm.compute(), jm.compute())


_CONFIGS = [(name, kw) for name in _MODULES for kw in ({}, {"query_without_relevant_docs": "neg"},
                                                         {"query_without_relevant_docs": "pos"})]
_CONFIGS += [(name, {"k": 2}) for name in _AT_K] + [("RetrievalMAP", {"exclude": 0})]


@pytest.mark.parametrize("name,kw", _CONFIGS, ids=[f"{n}{kw}" for n, kw in _CONFIGS])
def test_module_forward_and_epoch_equal_jax(name, kw):
    jm, tm = _pair(name, **kw)
    _run(jm, tm, _batches(6))
    tm.reset()
    jm.reset()
    _run(jm, tm, _batches(7, n_batches=2))


@pytest.mark.parametrize("name", _MODULES)
def test_module_capacity_mode_equals_list_mode_and_jax(name):
    batches = _batches(8)
    jm, tm = _pair(name, capacity=128)
    _run(jm, tm, batches)
    _, listed = _pair(name)
    for i, p, t in batches:
        listed.update(torch.from_numpy(i), torch.from_numpy(p), torch.from_numpy(t))
    torch.testing.assert_close(tm.compute(), listed.compute(), rtol=0, atol=0)


@pytest.mark.parametrize("name", _MODULES)
def test_module_error_policy_message_matches_jax(name):
    # queries 0 and 1 are fine for every metric; query 2 has only relevant rows (empty for
    # fall-out) and query 3 only non-relevant rows (empty for the rest)
    idx = np.array([0, 0, 1, 1, 2, 2, 3, 3])
    preds = np.array([0.9, 0.1, 0.3, 0.7, 0.5, 0.2, 0.8, 0.4], np.float32)
    target = np.array([1, 0, 0, 1, 1, 1, 0, 0])
    ok = idx < 2
    for rows in (ok, ok | (idx == 2), ok | (idx == 3)):
        jm, tm = _pair(name, query_without_relevant_docs="error")
        jm.update(jnp.asarray(idx[rows]), jnp.asarray(preds[rows]), jnp.asarray(target[rows]))
        tm.update(torch.from_numpy(idx[rows]), torch.from_numpy(preds[rows]), torch.from_numpy(target[rows]))
        try:
            want = jm.compute()
        except ValueError as e:
            with pytest.raises(ValueError) as got:
                tm.compute()
            assert str(got.value) == str(e)
            expected = "non-relevant" if name == "RetrievalFallOut" else "positive"
            assert expected in str(e) and (idx[rows] == (2 if name == "RetrievalFallOut" else 3)).any()
        else:
            _assert_same(tm.compute(), want)
            assert rows.sum() == 4 or (name == "RetrievalFallOut") == bool((idx[rows] == 3).any())


@pytest.mark.parametrize("name", _AT_K)
@pytest.mark.parametrize("k", [0, -1, 1.5])
def test_module_k_validation_matches_jax(name, k):
    with pytest.raises(ValueError, match="`k` has to be a positive integer or None"):
        getattr(mt, name)(k=k)
    with pytest.raises(ValueError, match="`k` has to be a positive integer or None"):
        getattr(pt, name)(k=k, device="cpu")


def test_module_checks_match_jax():
    for pkg, kw in ((mt, {}), (pt, {"device": "cpu"})):
        with pytest.raises(ValueError, match="`query_without_relevant_docs` received a wrong value"):
            pkg.RetrievalMAP(query_without_relevant_docs="maybe", **kw)
    jm, tm = _pair("RetrievalMAP")
    with pytest.raises(ValueError, match="must be of the same shape"):
        jm.update(jnp.zeros(3, jnp.int32), jnp.zeros(3), jnp.zeros(2, jnp.int32))
    with pytest.raises(ValueError, match="must be of the same shape"):
        tm.update(torch.zeros(3, dtype=torch.int32), torch.zeros(3), torch.zeros(2, dtype=torch.int32))
    # an epoch of no rows is 0.0 in both: an empty update, and an empty capacity buffer
    jm.update(jnp.zeros(0, jnp.int32), jnp.zeros(0), jnp.zeros(0, jnp.int32))
    tm.update(torch.zeros(0, dtype=torch.int32), torch.zeros(0), torch.zeros(0, dtype=torch.int32))
    assert float(jm.compute()) == float(tm.compute()) == 0.0
    jm, tm = _pair("RetrievalMAP", capacity=8)
    assert float(tm.compute()) == 0.0  # the port declares its buffers' layout, so they exist before an update
    jm.update(jnp.zeros(0, jnp.int32), jnp.zeros(0), jnp.zeros(0, jnp.int32))
    tm.update(torch.zeros(0, dtype=torch.int32), torch.zeros(0), torch.zeros(0, dtype=torch.int32))
    assert float(jm.compute()) == float(tm.compute()) == 0.0


def test_exports_match_jax():
    import metrics_tpu.retrieval as jr

    import metrics_tpu_torch.retrieval as tr

    public = lambda mod: {n for n in getattr(mod, "__all__", dir(mod)) if not n.startswith("_")}  # noqa: E731
    assert {n for n in public(jr) if n[0].isupper()} <= public(tr)
    assert pt.retrieval.IGNORE_IDX == jr.IGNORE_IDX == -100
    assert {n for n in public(mtr) if n.startswith(("grouped_", "retrieval_", "segment_", "sort_", "within_"))} <= public(ptr)
    for name in _MODULES:
        assert hasattr(pt, name) and hasattr(mt, name)
    for name in (n for n in dir(mtf) if n.startswith("retrieval_")):
        assert hasattr(ptf, name)


# ---------------------------------------------------------------- collections, groups
def _collection(pkg, capacity_map=False, **kw):
    members = [getattr(pkg, "RetrievalMAP")(**kw, **({"capacity": 256} if capacity_map else {})),
               pkg.RetrievalMRR(query_without_relevant_docs="neg", **kw), pkg.RetrievalPrecision(k=3, **kw),
               pkg.RetrievalRecall(k=4, **kw), pkg.RetrievalHitRate(k=2, **kw), pkg.RetrievalFallOut(k=2, **kw),
               pkg.RetrievalRPrecision(**kw), pkg.RetrievalNormalizedDCG(k=3, **kw)]
    return pkg.MetricCollection(members)


class _CountingRetrievalUpdates:
    def __enter__(self):
        self.calls = 0
        self._real = TorchMetric._run_update_on_state

        def counting(metric, state, *a, **k):
            self.calls += 1
            return self._real(metric, state, *a, **k)

        TorchMetric._run_update_on_state = counting
        return self

    def __exit__(self, *exc):
        TorchMetric._run_update_on_state = self._real


def test_collection_of_eight_is_one_compute_group_and_equals_jax():
    jcol, tcol = _collection(mt, jit=False), _collection(pt, device="cpu")
    assert list(tcol.compute_groups.values()) == [tuple(tcol.keys())] and len(tcol) == 8
    assert tcol.compute_groups == jcol.compute_groups
    batches = _batches(9)
    with _CountingRetrievalUpdates() as counter:
        for i, p, t in batches:
            want = jcol(jnp.asarray(i), jnp.asarray(p), jnp.asarray(t))
            got = tcol(torch.from_numpy(i), torch.from_numpy(p), torch.from_numpy(t))
            for k in want:
                _assert_same(got[k], want[k])
    assert counter.calls == len(batches)  # one update a step for the eight members
    want, got = jcol.compute(), tcol.compute()
    for k in want:
        _assert_same(got[k], want[k])


def test_capacity_member_splits_off_its_own_group():
    jcol, tcol = _collection(mt, capacity_map=True, jit=False), _collection(pt, capacity_map=True, device="cpu")
    groups = tcol.compute_groups
    assert groups == jcol.compute_groups
    assert groups["RetrievalMAP"] == ("RetrievalMAP",) and len(groups) == 2
    for i, p, t in _batches(10):
        tcol.update(torch.from_numpy(i), torch.from_numpy(p), torch.from_numpy(t))
        jcol.update(jnp.asarray(i), jnp.asarray(p), jnp.asarray(t))
    want, got = jcol.compute(), tcol.compute()
    for k in want:
        _assert_same(got[k], want[k])


def _toy_classes(base, tensor, **init_kw):
    class Toy(base):
        _GROUP_COMPUTE_ONLY_ATTRS = ("scale",)

        def __init__(self, offset=0.0, scale=1.0, **kw):
            super().__init__(**init_kw, **kw)
            self.offset, self.scale = offset, scale
            self.add_state("total", default=tensor(0.0), dist_reduce_fx="sum")

        def update(self, x):
            self.total = self.total + (x + self.offset).sum()

        def compute(self):
            return self.total * self.scale

    class ToyExtra(Toy):
        def __init__(self, extra=0, **kw):
            super().__init__(**kw)
            self.extra = extra

    class ToyListed(Toy):
        _GROUP_UPDATE_ATTRS = ("offset",)

    return Toy, ToyExtra, ToyListed


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_exclusion_form_group_key_on_a_toy_class(pkg):
    if pkg == "jax":
        Toy, ToyExtra, ToyListed = _toy_classes(JaxMetric, jnp.asarray)
    else:
        Toy, ToyExtra, ToyListed = _toy_classes(TorchMetric, torch.tensor, device="cpu")
    key = lambda m: m._group_fingerprint()  # noqa: E731
    assert key(Toy(scale=2.0)) == key(Toy(scale=3.0)) is not None  # compute-only: left out of the key
    assert key(Toy(offset=1.0)) != key(Toy(offset=2.0))  # update config: in the key
    assert key(ToyExtra(extra=1)) != key(ToyExtra(extra=2))  # a subclass's new attr joins the key by itself
    # the listed form wins when both are set: only ``offset`` (and capacity) is in the key
    assert key(ToyListed(offset=1.0)) == key(ToyListed(offset=1.0)) != key(ToyListed(offset=2.0))
    a, b = ToyListed(), ToyListed()
    b.unlisted = "ignored"
    assert key(a) == key(b)


def test_exclusion_form_groups_match_jax():
    results = {}
    for pkg, base, tensor, kw in (("jax", JaxMetric, jnp.asarray, {}), ("torch", TorchMetric, torch.tensor, {"device": "cpu"})):
        Toy, ToyExtra, _ = _toy_classes(base, tensor, **kw)
        coll_cls = mt.MetricCollection if pkg == "jax" else pt.MetricCollection
        col = coll_cls({"a": Toy(scale=2.0), "b": Toy(scale=5.0), "c": Toy(offset=1.0), "d": ToyExtra(extra=3)})
        results[pkg] = col.compute_groups
    assert results["torch"] == results["jax"] == {"a": ("a", "b"), "c": ("c",), "d": ("d",)}


def test_get_group_indexes_equals_jax():
    idx = np.array([5, 2, 5, 9, 2, 2, 7])
    want = [g.tolist() for g in jax_get_group_indexes(jnp.asarray(idx))]
    got = get_group_indexes(torch.from_numpy(idx))
    assert [g.tolist() for g in got] == want == [[0, 2], [1, 4, 5], [3], [6]]
    assert all(g.dtype == torch.int32 for g in got)


def test_accum_int_dtype_is_int64():
    from metrics_tpu_torch.utils.data import accum_int_dtype

    assert accum_int_dtype() == torch.int64


# -------------------------------------------------------------------------- repairs
@pytest.mark.parametrize("kw", [{"num_classes": 3, "average": "micro"}, {"num_classes": 3, "average": "macro"},
                                {"num_classes": 4, "average": "weighted"}, {"num_classes": 3, "average": "none"}])
def test_dice_equals_jax(kw):
    rng = np.random.RandomState(11)
    jm, tm = mt.Dice(**kw), pt.Dice(device="cpu", **kw)
    c = kw["num_classes"]
    for n in (16, 9, 20):
        preds, target = rng.randint(0, c, n), rng.randint(0, c, n)
        want = jm(jnp.asarray(preds), jnp.asarray(target))
        got = tm(torch.from_numpy(preds), torch.from_numpy(target))
        _assert_same(torch.stack(got) if isinstance(got, list) else got, np.asarray(want))
    want, got = jm.compute(), tm.compute()
    _assert_same(torch.stack(got) if isinstance(got, list) else got, np.asarray(want))
    assert isinstance(tm, pt.F1)


@pytest.mark.parametrize("shape,kw", [((0,), {"pos_label": 1}), ((0, 5), {"num_classes": 5})])
def test_empty_average_precision_raises_index_error_in_both(shape, kw):
    preds, target = np.zeros(shape, np.float32), np.zeros(0, np.int64)
    with pytest.raises(IndexError):
        mtf.average_precision(jnp.asarray(preds), jnp.asarray(target), **kw)
    with pytest.raises(IndexError):
        ptf.average_precision(torch.from_numpy(preds), torch.from_numpy(target), **kw)
