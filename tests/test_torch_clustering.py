"""Clustering (extrinsic and intrinsic) and nominal association in metrics_tpu_torch.

The same numpy-seeded labels and features go through both packages and
through sklearn / scipy:

* the contingency counts equal the JAX package's and a numpy ``bincount``
  bit for bit, out-of-range labels dropped;
* the nine extrinsic scores and the four nominal ones, functional and
  stateful over uneven batches, against the JAX package and sklearn / scipy;
* Calinski-Harabasz (streamed Chan merges) and Davies-Bouldin (list and
  ``capacity=`` modes) against the JAX package and sklearn;
* a JAX int32 contingency checkpoint loads into the port's int64 state;
* a collection's compute-group manifest equals the JAX collection's (the
  contingency metrics declare no group key in either package);
* T3, the expected mutual information: the port's AMI against sklearn at
  N = 10**4, 10**5 and 10**6 (float64 throughout), and against the JAX
  package below 10**4, where its float32 sweep is still within the tolerance.

Tolerances: counts are equal. The port computes every closed form in float64
from exact counts and rounds once to float32, so against sklearn / scipy
(float64) it holds rtol 1e-6; against the JAX package's float32 forms rtol 1e-5
(its own tests allow 1e-4 against sklearn), and for AMI, whose float32 EMI
sweep the JAX package bounds at atol 2e-3 in its tests, atol 1e-4. CH / DB
are float32 moments on both sides: rtol 1e-5 against the JAX package and
1e-4 against sklearn, the JAX package's own test tolerance.
"""
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.stats.contingency import association
from sklearn import metrics as sk

import metrics_tpu as mt
import metrics_tpu.functional as JF
import metrics_tpu_torch as pt
import metrics_tpu_torch.functional as PF
from metrics_tpu_torch.functional import clustering as pclust

_EXTRINSIC = [
    ("rand_score", "RandScore", sk.rand_score),
    ("adjusted_rand_score", "AdjustedRandScore", sk.adjusted_rand_score),
    ("mutual_info_score", "MutualInfoScore", sk.mutual_info_score),
    ("normalized_mutual_info_score", "NormalizedMutualInfoScore", sk.normalized_mutual_info_score),
    ("adjusted_mutual_info_score", "AdjustedMutualInfoScore", sk.adjusted_mutual_info_score),
    ("homogeneity_score", "HomogeneityScore", sk.homogeneity_score),
    ("completeness_score", "CompletenessScore", sk.completeness_score),
    ("v_measure_score", "VMeasureScore", sk.v_measure_score),
    ("fowlkes_mallows_score", "FowlkesMallowsScore", sk.fowlkes_mallows_score),
]
_NOMINAL = [
    ("cramers_v", "CramersV", "cramer"),
    ("pearsons_contingency_coefficient", "PearsonsContingencyCoefficient", "pearson"),
    ("tschuprows_t", "TschuprowsT", "tschuprow"),
]
RTOL_SK = 1e-6
RTOL_JAX = 1e-5
ATOL_AMI_JAX = 1e-4


def _labels(seed, n, clusters, classes, follow=0.6):
    rng = np.random.default_rng(seed)
    target = rng.integers(0, classes, n)
    preds = np.where(rng.random(n) < follow, target % clusters, rng.integers(0, clusters, n))
    return preds, target


def test_contingency_counts_equal_jax_and_bincount_dropping_out_of_range():
    preds, target = _labels(1, 2000, 7, 5)
    preds[:7] = [-1, 7, 9, 0, 3, 6, 2]
    target[:7] = [0, 1, 2, -3, 5, 4, 8]
    got = pclust._contingency(torch.from_numpy(preds), torch.from_numpy(target), 7, 5)
    want = np.asarray(__import__("metrics_tpu.functional.clustering", fromlist=["_"])._contingency(
        jnp.asarray(preds), jnp.asarray(target), 7, 5))
    inside = (preds >= 0) & (preds < 7) & (target >= 0) & (target < 5)
    oracle = np.bincount(preds[inside] * 5 + target[inside], minlength=35).reshape(7, 5)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), oracle)


@pytest.mark.parametrize("fn_name, cls_name, sk_fn", _EXTRINSIC)
def test_extrinsic_scores_equal_jax_and_sklearn(fn_name, cls_name, sk_fn):
    batches = [_labels(10 + i, n, 7, 5) for i, n in enumerate((120, 1, 77, 300))]
    preds = np.concatenate([p for p, _ in batches])
    target = np.concatenate([t for _, t in batches])
    want_sk = sk_fn(target, preds)
    got = float(getattr(PF, fn_name)(torch.from_numpy(preds), torch.from_numpy(target), 7, 5))
    want_jax = float(getattr(JF, fn_name)(jnp.asarray(preds), jnp.asarray(target), 7, 5))
    np.testing.assert_allclose(got, want_sk, rtol=RTOL_SK)
    if fn_name == "adjusted_mutual_info_score":
        np.testing.assert_allclose(got, want_jax, atol=ATOL_AMI_JAX)
    else:
        np.testing.assert_allclose(got, want_jax, rtol=RTOL_JAX)
    port, ref = getattr(pt, cls_name)(7, 5, device="cpu"), getattr(mt, cls_name)(7, 5)
    for p, t in batches:
        port.update(torch.from_numpy(p), torch.from_numpy(t))
        ref.update(jnp.asarray(p), jnp.asarray(t))
    np.testing.assert_array_equal(port.contingency.numpy(), np.asarray(ref.contingency))
    np.testing.assert_allclose(float(port.compute()), want_sk, rtol=RTOL_SK)


@pytest.mark.parametrize("average_method", ["arithmetic", "geometric", "min", "max"])
def test_normalized_and_adjusted_mutual_info_average_methods(average_method):
    preds, target = _labels(2, 500, 6, 4)
    tp, tt = torch.from_numpy(preds), torch.from_numpy(target)
    np.testing.assert_allclose(float(PF.normalized_mutual_info_score(tp, tt, 6, 4, average_method)),
                               sk.normalized_mutual_info_score(target, preds, average_method=average_method),
                               rtol=RTOL_SK)
    np.testing.assert_allclose(float(PF.adjusted_mutual_info_score(tp, tt, 6, 4, average_method)),
                               sk.adjusted_mutual_info_score(target, preds, average_method=average_method),
                               rtol=RTOL_SK)
    got = pt.VMeasureScore(6, 4, beta=2.0, device="cpu")(tp, tt)
    np.testing.assert_allclose(float(got), sk.v_measure_score(target, preds, beta=2.0), rtol=RTOL_SK)


def test_degenerate_labelings_follow_sklearn():
    one = np.zeros(40, np.int64)
    t = np.random.default_rng(3).integers(0, 3, 40)
    for fn_name, _, sk_fn in _EXTRINSIC:
        fn = getattr(PF, fn_name)
        np.testing.assert_allclose(float(fn(torch.from_numpy(one), torch.from_numpy(one), 1, 1)), sk_fn(one, one),
                                   atol=1e-7, err_msg=fn_name)
        np.testing.assert_allclose(float(fn(torch.from_numpy(one), torch.from_numpy(t), 1, 3)), sk_fn(t, one),
                                   atol=1e-7, err_msg=fn_name)


@pytest.mark.parametrize("n", [10_000, 100_000, 1_000_000])
def test_ami_float64_sweep_equals_sklearn_at_large_epochs(n):
    """T3: the port's EMI is float64 over each cell's feasible range, so AMI holds sklearn at any N. The JAX
    package's float32 sweep is measured beside it (run with ``-s`` to print both): it drifts from sklearn by
    1.97e-5, 6.9e-6 and 6.7e-5 relative at these three sizes, inside its own tests' atol 2e-3, which is
    asserted as the reference's property."""
    preds, target = _labels(n, n, 10, 10)
    got = float(PF.adjusted_mutual_info_score(torch.from_numpy(preds), torch.from_numpy(target), 10, 10))
    want = sk.adjusted_mutual_info_score(target, preds)
    jax_value = float(JF.adjusted_mutual_info_score(jnp.asarray(preds), jnp.asarray(target), 10, 10))
    print(f"\nAMI at N={n}: sklearn {want!r}, port {got!r} (rel {abs(got - want) / want:.2e}), JAX package"
          f" {jax_value!r} (rel {abs(jax_value - want) / want:.2e})")
    np.testing.assert_allclose(got, want, rtol=RTOL_SK)
    np.testing.assert_allclose(jax_value, want, atol=2e-3)


@pytest.mark.parametrize("n", [300, 3_000])
def test_ami_equals_jax_below_ten_thousand_samples(n):
    preds, target = _labels(n, n, 10, 10)
    got = float(PF.adjusted_mutual_info_score(torch.from_numpy(preds), torch.from_numpy(target), 10, 10))
    want = float(JF.adjusted_mutual_info_score(jnp.asarray(preds), jnp.asarray(target), 10, 10))
    np.testing.assert_allclose(got, want, atol=ATOL_AMI_JAX)


def test_emi_chunking_and_chernoff_window_change_nothing():
    preds, target = _labels(4, 60_000, 40, 30)
    cont = pclust._contingency(torch.from_numpy(preds), torch.from_numpy(target), 40, 30)
    whole = pclust._expected_mutual_info(cont, 60_000)
    chunked = pclust._expected_mutual_info(cont, 60_000, chunk_terms=4_099)
    cutoff = pclust._EMI_LOG_CUTOFF
    try:
        pclust._EMI_LOG_CUTOFF = float("inf")  # every feasible k
        full = pclust._expected_mutual_info(cont, 60_000)
    finally:
        pclust._EMI_LOG_CUTOFF = cutoff
    np.testing.assert_allclose(chunked.item(), whole.item(), rtol=1e-13)
    np.testing.assert_allclose(full.item(), whole.item(), rtol=1e-13)


@pytest.mark.parametrize("fn_name, cls_name, method", _NOMINAL)
def test_nominal_scores_equal_jax_and_scipy(fn_name, cls_name, method):
    batches = [_labels(20 + i, n, 5, 4, follow=0.5) for i, n in enumerate((90, 3, 210))]
    preds = np.concatenate([p for p, _ in batches])
    target = np.concatenate([t for _, t in batches])
    table = np.bincount(preds * 4 + target, minlength=20).reshape(5, 4)
    want = association(table, method=method)
    got = float(getattr(PF, fn_name)(torch.from_numpy(preds), torch.from_numpy(target), 5, 4))
    np.testing.assert_allclose(got, want, rtol=RTOL_SK)
    np.testing.assert_allclose(got, float(getattr(JF, fn_name)(jnp.asarray(preds), jnp.asarray(target), 5, 4)),
                               rtol=RTOL_JAX)
    port, ref = getattr(pt, cls_name)(5, 4, device="cpu"), getattr(mt, cls_name)(5, 4)
    for p, t in batches:
        port.update(torch.from_numpy(p), torch.from_numpy(t))
        ref.update(jnp.asarray(p), jnp.asarray(t))
    np.testing.assert_allclose(float(port.compute()), float(ref.compute()), rtol=RTOL_JAX)


def _theils_u_oracle(preds, target):
    table = np.bincount(preds * 4 + target, minlength=20).reshape(5, 4).astype(np.float64)
    n = table.sum()
    pt_ = table.sum(0) / n
    h_t = -np.sum(pt_[pt_ > 0] * np.log(pt_[pt_ > 0]))
    rows = table.sum(1)
    h_cond = 0.0
    for r, tot in zip(table, rows):
        if tot:
            p = r[r > 0] / tot
            h_cond += tot / n * -np.sum(p * np.log(p))
    return (h_t - h_cond) / h_t


def test_theils_u_and_bias_corrected_cramers_v_equal_jax_and_float64_oracles():
    preds, target = _labels(30, 400, 5, 4, follow=0.5)
    tp, tt = torch.from_numpy(preds), torch.from_numpy(target)
    np.testing.assert_allclose(float(PF.theils_u(tp, tt, 5, 4)), _theils_u_oracle(preds, target), rtol=RTOL_SK)
    np.testing.assert_allclose(float(PF.theils_u(tp, tt, 5, 4)),
                               float(JF.theils_u(jnp.asarray(preds), jnp.asarray(target), 5, 4)), rtol=RTOL_JAX)
    np.testing.assert_allclose(float(PF.cramers_v(tp, tt, 5, 4, bias_correction=True)),
                               float(JF.cramers_v(jnp.asarray(preds), jnp.asarray(target), 5, 4, True)), rtol=RTOL_JAX)
    got = pt.CramersV(5, 4, bias_correction=True, device="cpu")(tp, tt)
    ref = mt.CramersV(5, 4, bias_correction=True)(jnp.asarray(preds), jnp.asarray(target))
    np.testing.assert_allclose(float(got), float(ref), rtol=RTOL_JAX)
    np.testing.assert_allclose(float(pt.TheilsU(5, 4, device="cpu")(tp, tt)), _theils_u_oracle(preds, target),
                               rtol=RTOL_SK)


def _blobs(seed, n, d, k):
    rng = np.random.default_rng(seed)
    centres = rng.normal(scale=4.0, size=(k, d))
    labels = rng.integers(0, k, n)
    return (centres[labels] + rng.normal(size=(n, d))).astype(np.float32), labels


def test_calinski_harabasz_streamed_equals_jax_and_sklearn():
    data, labels = _blobs(5, 600, 6, 5)
    labels[labels == 4] = 3  # cluster 4 stays empty
    splits = [0, 150, 151, 420, 600]
    port, ref = pt.CalinskiHarabaszScore(5, 6, device="cpu"), mt.CalinskiHarabaszScore(5, 6)
    for a, b in zip(splits[:-1], splits[1:]):
        got = port(torch.from_numpy(data[a:b]), torch.from_numpy(labels[a:b]))
        want = ref(jnp.asarray(data[a:b]), jnp.asarray(labels[a:b]))
        np.testing.assert_allclose(float(got), float(want), rtol=RTOL_JAX)
    np.testing.assert_allclose(port.moments.numpy(), np.asarray(ref.moments), rtol=RTOL_JAX, atol=1e-4)
    np.testing.assert_allclose(float(port.compute()), float(ref.compute()), rtol=RTOL_JAX)
    np.testing.assert_allclose(float(port.compute()), sk.calinski_harabasz_score(data, labels), rtol=1e-4)
    np.testing.assert_allclose(float(PF.calinski_harabasz_score(torch.from_numpy(data), torch.from_numpy(labels), 5)),
                               sk.calinski_harabasz_score(data, labels), rtol=1e-4)


@pytest.mark.parametrize("capacity", [None, 1024])
def test_davies_bouldin_equals_jax_and_sklearn(capacity):
    data, labels = _blobs(6, 500, 7, 6)
    port, ref = pt.DaviesBouldinScore(6, device="cpu", capacity=capacity), mt.DaviesBouldinScore(6)
    for a, b in ((0, 200), (200, 201), (201, 500)):
        port.update(torch.from_numpy(data[a:b]), torch.from_numpy(labels[a:b]))
        ref.update(jnp.asarray(data[a:b]), jnp.asarray(labels[a:b]))
    got = float(port.compute())
    np.testing.assert_allclose(got, float(ref.compute()), rtol=RTOL_JAX)
    np.testing.assert_allclose(got, sk.davies_bouldin_score(data, labels), rtol=1e-4)
    assert np.isnan(float(pt.DaviesBouldinScore(6, device="cpu").compute()))


def test_jax_int32_contingency_checkpoint_loads_into_the_int64_state():
    preds, target = _labels(7, 800, 7, 5)
    ref = mt.AdjustedRandScore(7, 5)
    ref.update(jnp.asarray(preds), jnp.asarray(target))
    ref.persistent(True)
    saved = ref.state_dict()
    assert np.asarray(saved["contingency"]).dtype == np.int32
    port = pt.AdjustedRandScore(7, 5, device="cpu")
    port.load_state_dict(saved)
    assert port.contingency.dtype == torch.int64
    np.testing.assert_array_equal(port.contingency.numpy(), np.asarray(ref.contingency))
    np.testing.assert_allclose(float(port.compute()), sk.adjusted_rand_score(target, preds), rtol=RTOL_SK)


def _contingency_collection(pkg, **kw):
    return pkg.MetricCollection({
        "rand": pkg.RandScore(7, 5, **kw), "ari": pkg.AdjustedRandScore(7, 5, **kw),
        "nmi": pkg.NormalizedMutualInfoScore(7, 5, **kw), "ami": pkg.AdjustedMutualInfoScore(7, 5, **kw),
        "cramers": pkg.CramersV(7, 5, **kw), "theil": pkg.TheilsU(7, 5, **kw),
    })


def test_compute_group_manifest_equals_the_jax_collections():
    ref, port = _contingency_collection(mt), _contingency_collection(pt, device="cpu")
    assert port.compute_groups == ref.compute_groups
    ref.persistent(True)
    port.persistent(True)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for seed in range(2):
            preds, target = _labels(40 + seed, 300, 7, 5)
            got = port(torch.from_numpy(preds), torch.from_numpy(target))
            want = ref(jnp.asarray(preds), jnp.asarray(target))
            for k in want:
                tol = {"atol": ATOL_AMI_JAX} if k == "ami" else {"rtol": RTOL_JAX}
                np.testing.assert_allclose(float(got[k]), float(want[k]), **tol, err_msg=k)
    ref_sd, port_sd = ref.state_dict(), port.state_dict()
    assert sorted(port_sd) == sorted(ref_sd)
    assert port_sd["_compute_group_manifest"] == ref_sd["_compute_group_manifest"]
