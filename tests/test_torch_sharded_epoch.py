"""The sharded epoch engines across four real processes (Gloo), against the JAX engines.

Four ranks over ``torch.distributed`` (Gloo, a FileStore under ``tmp_path``)
each hold one block of 256 rows of a seeded global epoch of 1,024 rows, made
from a numpy seed in the child and here alike, and run every engine of
``metrics_tpu_torch.parallel.sharded_epoch`` twice: over the flat world and
over a ``MeshHierarchy`` of 2 slices of 2 (``hierarchical_mesh(slices=2)``).
The same global rows go through the JAX package's engines inside
``shard_map`` over a flat 4-device mesh and a ``(2, 2)`` ``("dcn", "ici")``
mesh of the conftest's virtual CPU devices (256 rows a device, the port's
block), and through sklearn / scipy on the concatenated epoch:

* exact AUROC and AP with and without cross-shard ties; weighted rows, zero
  weights, a single-class epoch (``nan``); per-class matrices (weighted too);
  an absent class (``nan``);
* ``sharded_clf_curve_matrix`` against ``sklearn.metrics.roc_curve``;
  ``sharded_rank`` / ``sharded_spearman`` / ``sharded_kendall`` against scipy;
* the regroup: every row arrives exactly once, on rank ``q mod 4``; retrieval
  MAP and MRR under the empty-query policies with exclude sentinels against
  the unsharded port and the JAX engine; bucket overflow counted;
* the counters: the port counts the hops and exchanges it executes, n - 1
  ``ppermute`` a flat ring (3) and L - 1 a two-level one (1, after one ``dcn``
  ``all_gather``), 4 ``all_to_all`` a flat regroup and 8 two-level, with ring
  traffic ``payload * (fanout - 1)`` by crossing. The JAX package counts what it
  stages once a trace (3 ``ppermute`` + 1 ``psum`` for a binary AUROC, 4
  ``all_to_all`` + 3 ``psum`` for MRR, ``bench.py:2626-2731``): both are held,
  neither forced onto the other.

The children run once for the module; this process never joins a group.
Tolerances, stated per test: float32 values against sklearn / scipy within
``ATOL`` (1e-6; weighted within ``RTOL_W``, 1e-5); the port against the JAX
engines within ``ATOL``; counts and routed rows exact.
"""
import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P
from sklearn.metrics import average_precision_score as sk_ap
from sklearn.metrics import roc_auc_score as sk_auroc
from sklearn.metrics import roc_curve as sk_roc_curve

from metrics_tpu.parallel import placement as jplacement
from metrics_tpu.parallel import sharded_epoch as jse
from metrics_tpu.utils import compat
from tests.test_torch_faults import plane_hygiene  # noqa: F401  (autouse: every test leaves the process clean)

torch.set_num_threads(1)

_REPO = Path(__file__).resolve().parents[1]
WORLD, N = 4, 1024
ATOL = 1e-6
RTOL_W = 1e-5

# the global epoch, made the same way here and in every child
_DATA = textwrap.dedent("""
    import numpy as np

    N, C = 1024, 5

    def epoch_data():
        rng = np.random.RandomState(41)
        d = {}
        d["p"] = rng.rand(N).astype(np.float32)
        d["pt"] = np.round(d["p"], 1)  # heavy cross-shard ties
        d["t"] = (rng.rand(N) > 0.6).astype(np.int32)
        d["w"] = rng.rand(N).astype(np.float32)
        d["w0"] = d["w"].copy()
        d["w0"][::3] = 0.0
        d["ones"] = np.ones(N, np.int32)
        d["pm"] = np.round(rng.rand(N, C), 1).astype(np.float32)
        labels = rng.randint(0, C, N)
        d["onehot"] = (labels[:, None] == np.arange(C)).astype(np.int32)
        absent = np.zeros((N, 3), np.int32)
        absent[:, 0] = (rng.rand(N) > 0.5).astype(np.int32)
        d["absent"] = absent
        d["q"] = np.round(d["p"] + 0.3 * rng.randn(N), 1).astype(np.float32)
        d["idx"] = rng.randint(0, 37, N).astype(np.int32)
        d["rt"] = (rng.rand(N) > 0.5).astype(np.int32)
        d["rt"][d["idx"] % 7 == 0] = 0  # all-negative queries
        sentinel = (np.arange(N) % 11 == 0) & (d["idx"] % 7 != 0)
        d["rt"][sentinel] = -100
        d["zeros"] = np.zeros(N, np.int32)
        return d
""")
exec(_DATA)  # noqa: S102  (defines N, C, epoch_data here as in the children)

_WORKER = _DATA + textwrap.dedent("""
    import json, sys, warnings
    import torch, torch.distributed as dist
    sys.path.insert(0, sys.argv[4])
    import metrics_tpu_torch as pt
    from metrics_tpu_torch.observability import counters
    from metrics_tpu_torch.parallel import sharded_epoch as se
    from metrics_tpu_torch.retrieval import RetrievalMAP, RetrievalMRR

    warnings.simplefilter("ignore")
    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=4)
    h = pt.parallel.hierarchical_mesh(slices=2)
    d = epoch_data()
    m = N // 4
    b = {k: torch.from_numpy(v[rank * m:(rank + 1) * m]) for k, v in d.items()}
    res = {"grid": [list(g) for g in h.grid]}

    def host(v):
        if isinstance(v, (tuple, list)):
            return [host(x) for x in v]
        return v.tolist()

    def run(name, fn):
        counters.reset()
        counters.enable()
        value = fn()
        snap = counters.snapshot()
        counters.disable()
        res[name] = host(value)
        res[name + "#calls"] = snap["calls_by_kind"]
        res[name + "#bytes"] = snap["bytes_by_crossing"]

    for tag, g in (("flat", None), ("hier", h)):
        for ties in ("p", "pt"):
            run(f"{tag}/auroc/{ties}", lambda: se.sharded_auroc(b[ties], b["t"], g))
            run(f"{tag}/ap/{ties}", lambda: se.sharded_average_precision(b[ties], b["t"], g))
        run(f"{tag}/auroc_w", lambda: se.sharded_auroc(b["pt"], b["t"], g, b["w"]))
        run(f"{tag}/auroc_w0", lambda: se.sharded_auroc(b["pt"], b["t"], g, b["w0"]))
        run(f"{tag}/auroc_single", lambda: se.sharded_auroc(b["pt"], b["ones"], g, b["w"]))
        run(f"{tag}/auroc_matrix", lambda: se.sharded_auroc_matrix(b["pm"], b["onehot"], g))
        run(f"{tag}/auroc_matrix_w", lambda: se.sharded_auroc_matrix(b["pm"], b["onehot"], g, b["w0"]))
        run(f"{tag}/auroc_absent", lambda: se.sharded_auroc_matrix(b["pm"][:, :3], b["absent"], g))
        run(f"{tag}/ap_matrix", lambda: se.sharded_average_precision_matrix(b["pm"], b["onehot"], g))
        run(f"{tag}/curve", lambda: se.sharded_clf_curve_matrix(
            b["pt"][None, :], b["t"].float()[None, :], torch.ones(1, m), g))
        run(f"{tag}/rank", lambda: se.sharded_rank(b["pt"], g))
        run(f"{tag}/spearman", lambda: se.sharded_spearman(b["pt"], b["q"], g))
        run(f"{tag}/kendall", lambda: se.sharded_kendall(b["pt"], b["q"], g, chunk=100))
        run(f"{tag}/regroup", lambda: se.regroup_by_query(b["idx"], b["p"], b["rt"], g))
        run(f"{tag}/overflow", lambda: se.regroup_by_query(b["zeros"], b["p"], b["ones"], g, capacity=8)[4])
        run(f"{tag}/map", lambda: se.sharded_retrieval_sums(RetrievalMAP(device="cpu"), b["idx"], b["p"], b["t"], g))
        for policy in ("skip", "neg", "pos"):
            run(f"{tag}/mrr/{policy}", lambda: se.sharded_retrieval_sums(
                RetrievalMRR(query_without_relevant_docs=policy, device="cpu"), b["idx"], b["p"], b["rt"], g))
    json.dump(res, open(out, "w"))
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_epoch")
    script = tmp / "worker.py"
    script.write_text(_WORKER)
    procs = [
        subprocess.Popen([sys.executable, str(script), str(r), str(tmp / "store"), str(tmp / f"out{r}.json"),
                          str(_REPO)], env=dict(os.environ, OMP_NUM_THREADS="1"), stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True)
        for r in range(WORLD)
    ]
    try:
        logs = [p.communicate(timeout=150)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0] * WORLD, logs
    return [json.loads((tmp / f"out{r}.json").read_text()) for r in range(WORLD)]


@pytest.fixture(scope="module")
def data():
    return epoch_data()  # noqa: F821  (defined by exec(_DATA))


def _jax(eight_devices, hier, fn, n_in, out_specs=P()):
    """The JAX engine over 4 virtual devices (256 rows each), flat or ``(2, 2)``."""
    devices = eight_devices[:WORLD]
    if hier:
        mesh, h = jplacement.hierarchical_mesh(devices, slices=2)
        axis, spec = h, P(h.axes)
    else:
        mesh, axis, spec = Mesh(np.array(devices), ("dp",)), "dp", P("dp")
    return jax.jit(compat.shard_map(lambda *a: fn(axis, *a), mesh=mesh, in_specs=(spec,) * n_in,
                                    out_specs=out_specs, check_vma=False))


def _same_on_every_rank(ranks, key):
    first = ranks[0][key]
    for r in ranks[1:]:
        np.testing.assert_equal(r[key], first, err_msg=key)  # nan equals nan here
    return first


TAGS = ("flat", "hier")


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("ties", ["p", "pt"])
def test_auroc_and_ap_exact(ranks, data, eight_devices, tag, ties):
    """Binary AUROC / AP with and without cross-shard ties: every rank equal,
    within ATOL of sklearn and of the JAX engine on the same mesh shape."""
    p, t = data[ties], data["t"]
    for kind, oracle, engine in (("auroc", sk_auroc, jse.sharded_auroc), ("ap", sk_ap, jse.sharded_average_precision)):
        got = _same_on_every_rank(ranks, f"{tag}/{kind}/{ties}")
        np.testing.assert_allclose(got, oracle(t, p), atol=ATOL)
        jv = float(_jax(eight_devices, tag == "hier", lambda ax, a, b: engine(a, b, ax), 2)(jnp.asarray(p),
                                                                                          jnp.asarray(t)))
        np.testing.assert_allclose(got, jv, atol=ATOL)


@pytest.mark.parametrize("tag", TAGS)
def test_auroc_weighted_zero_weights_and_degenerate(ranks, data, tag):
    """Weighted rows within RTOL_W of sklearn; zero weight is neutral; one class globally is nan."""
    p, t, w, w0 = data["pt"], data["t"], data["w"], data["w0"]
    np.testing.assert_allclose(_same_on_every_rank(ranks, f"{tag}/auroc_w"), sk_auroc(t, p, sample_weight=w),
                               rtol=RTOL_W)
    keep = w0 > 0
    np.testing.assert_allclose(_same_on_every_rank(ranks, f"{tag}/auroc_w0"),
                               sk_auroc(t[keep], p[keep], sample_weight=w0[keep]), rtol=RTOL_W)
    assert np.isnan(_same_on_every_rank(ranks, f"{tag}/auroc_single"))


@pytest.mark.parametrize("tag", TAGS)
def test_per_class_matrices(ranks, data, eight_devices, tag):
    """Per-class AUROC / AP (ATOL; the weighted matrix RTOL_W) against sklearn,
    the unweighted AUROC matrix against the JAX engine; an absent class is nan."""
    pm, onehot, w0 = data["pm"], data["onehot"], data["w0"]
    got = np.array(_same_on_every_rank(ranks, f"{tag}/auroc_matrix"))
    np.testing.assert_allclose(got, [sk_auroc(onehot[:, c], pm[:, c]) for c in range(pm.shape[1])], atol=ATOL)
    jv = _jax(eight_devices, tag == "hier", lambda ax, a, b: jse.sharded_auroc_matrix(a, b, ax), 2)(
        jnp.asarray(pm), jnp.asarray(onehot))
    np.testing.assert_allclose(got, np.asarray(jv), atol=ATOL)
    keep = w0 > 0
    np.testing.assert_allclose(
        _same_on_every_rank(ranks, f"{tag}/auroc_matrix_w"),
        [sk_auroc(onehot[keep, c], pm[keep, c], sample_weight=w0[keep]) for c in range(pm.shape[1])], rtol=RTOL_W)
    np.testing.assert_allclose(_same_on_every_rank(ranks, f"{tag}/ap_matrix"),
                               [sk_ap(onehot[:, c], pm[:, c]) for c in range(pm.shape[1])], atol=ATOL)
    absent = np.array(_same_on_every_rank(ranks, f"{tag}/auroc_absent"), dtype=np.float64)
    assert not np.isnan(absent[0]) and np.isnan(absent[1]) and np.isnan(absent[2])


@pytest.mark.parametrize("tag", TAGS)
def test_clf_curve_matrix(ranks, data, eight_devices, tag):
    """The compacted global curve: every distinct threshold of sklearn's
    ``roc_curve`` (exact), fps / tps exact counts, the same as the JAX engine's."""
    p, t = data["pt"], data["t"]
    fps, tps, th, counts = (np.array(x) for x in _same_on_every_rank(ranks, f"{tag}/curve"))
    k = int(counts[0])
    sk_fpr, sk_tpr, sk_th = sk_roc_curve(t, p, drop_intermediate=False)
    assert k == len(sk_th) - 1
    np.testing.assert_array_equal(th[0, :k], sk_th[1:].astype(np.float32))
    np.testing.assert_allclose(fps[0, :k] / fps[0, k - 1], sk_fpr[1:], atol=ATOL)
    np.testing.assert_allclose(tps[0, :k] / tps[0, k - 1], sk_tpr[1:], atol=ATOL)
    assert np.all(th[0, k:] == th[0, k - 1]) and np.all(fps[0, k:] == fps[0, k - 1])
    jv = _jax(eight_devices, tag == "hier",
              lambda ax, a, b, w: jse.sharded_clf_curve_matrix(a.T, b.T, w.T, ax), 3, out_specs=(P(), P(), P(), P()))(
        jnp.asarray(p[:, None]), jnp.asarray(t[:, None].astype(np.float32)), jnp.ones((N, 1), jnp.float32))
    assert int(jv[3][0]) == k
    np.testing.assert_array_equal(np.asarray(jv[0])[0, :k], fps[0, :k])
    np.testing.assert_array_equal(np.asarray(jv[1])[0, :k], tps[0, :k])


@pytest.mark.parametrize("tag", TAGS)
def test_ranks_spearman_kendall(ranks, data, eight_devices, tag):
    """Midranks equal scipy's ``rankdata`` exactly (ties on every rank); rho and
    tau-b within ATOL of scipy and of the JAX engines."""
    p, q = data["pt"], data["q"]
    got_ranks = np.concatenate([r[f"{tag}/rank"] for r in ranks])
    np.testing.assert_array_equal(got_ranks, st.rankdata(p))
    for kind, oracle, engine in (("spearman", st.spearmanr, jse.sharded_spearman),
                                 ("kendall", st.kendalltau, jse.sharded_kendall)):
        got = _same_on_every_rank(ranks, f"{tag}/{kind}")
        np.testing.assert_allclose(got, oracle(p, q).statistic, atol=ATOL)
        jv = float(_jax(eight_devices, tag == "hier", lambda ax, a, b: engine(a, b, ax), 2)(jnp.asarray(p),
                                                                                          jnp.asarray(q)))
        np.testing.assert_allclose(got, jv, atol=ATOL)


@pytest.mark.parametrize("tag", TAGS)
def test_regroup_routes_and_pads(ranks, data, tag):
    """Every real row arrives exactly once, with its (idx, pred, target), on
    rank ``q mod 4`` (flat and two-level alike); nothing is dropped."""
    rows = []
    for r, res in enumerate(ranks):
        gi, gp, gt, pad, dropped = res[f"{tag}/regroup"]
        assert dropped == 0
        real = ~np.array(pad)
        gi, gp, gt = np.array(gi)[real], np.array(gp)[real], np.array(gt)[real]
        assert np.all(gi % WORLD == r)
        assert np.all(np.array(res[f"{tag}/regroup"][0])[~real] == np.iinfo(np.int32).max)
        rows += list(zip(gi.tolist(), gp.tolist(), gt.tolist()))
    want = list(zip(data["idx"].tolist(), data["p"].tolist(), data["rt"].tolist()))
    assert sorted(rows) == sorted(want)


@pytest.mark.parametrize("tag", TAGS)
def test_regroup_overflow_counted(ranks, data, eight_devices, tag):
    """Every row to rank 0 with 8-row buckets: the drops are counted, never
    silent: 4 x (256 - 8) flat, as the JAX engine counts on 4 devices; the
    two-level regroup counts its two stages' drops."""
    dropped = _same_on_every_rank(ranks, f"{tag}/overflow")
    jv = int(_jax(eight_devices, tag == "hier", lambda ax, i, p, t: jse.regroup_by_query(i, p, t, ax, capacity=8)[4],
                  3)(jnp.asarray(data["zeros"]), jnp.asarray(data["p"]), jnp.asarray(data["ones"])))
    assert dropped == jv
    if tag == "flat":
        assert dropped == WORLD * (N // WORLD - 8)


@pytest.mark.parametrize("tag", TAGS)
@pytest.mark.parametrize("policy", ["map", "skip", "neg", "pos"])
def test_retrieval_sums(ranks, data, eight_devices, tag, policy):
    """RetrievalMAP and RetrievalMRR (empty-query policies, exclude sentinels)
    through the regroup: within ATOL of the unsharded port and the JAX engine;
    the empty-query flag is seen globally; nothing dropped."""
    import metrics_tpu.retrieval as jret
    from metrics_tpu_torch.retrieval import RetrievalMAP, RetrievalMRR

    idx, p = data["idx"], data["p"]
    if policy == "map":
        t, key, make, jmake = data["t"], f"{tag}/map", lambda: RetrievalMAP(device="cpu"), lambda: jret.RetrievalMAP()
    else:
        t, key = data["rt"], f"{tag}/mrr/{policy}"
        make = lambda: RetrievalMRR(query_without_relevant_docs=policy, device="cpu")  # noqa: E731
        jmake = lambda: jret.RetrievalMRR(query_without_relevant_docs=policy)  # noqa: E731
    mean, flag, dropped = _same_on_every_rank(ranks, key)
    assert dropped == 0
    plain = make()
    plain.update(torch.from_numpy(idx), torch.from_numpy(p), torch.from_numpy(t))
    np.testing.assert_allclose(mean, float(plain.compute()), atol=ATOL)
    jm = jmake()
    jv = _jax(eight_devices, tag == "hier", lambda ax, i, a, b: jse.sharded_retrieval_sums(jm, i, a, b, ax), 3,
              out_specs=(P(), P(), P()))(jnp.asarray(idx), jnp.asarray(p), jnp.asarray(t))
    np.testing.assert_allclose(mean, float(jv[0]), atol=ATOL)
    assert flag == bool(jv[1])
    if policy != "map":
        assert flag  # the all-negative queries are visible globally


def test_collective_counts(ranks):
    """The port counts what it executes: a flat binary AUROC is 3 ring hops
    (``ppermute``, 3 x 256 x 3 float32 = 9,216 B a hop, ring traffic x 3 at
    ``world``) and 1 ``psum``; two-level, one ``dcn`` ``all_gather`` of the
    pack and 1 hop over ``ici``. A flat MRR regroup is 4 ``all_to_all`` (3
    payloads and the mask) and 3 ``psum``; two-level 8 and 4. (The JAX package
    stages 3 ``ppermute`` + 1 ``psum`` and 4 ``all_to_all`` + 3 ``psum``.)"""
    pack = 3 * (N // WORLD) * 4
    calls = _same_on_every_rank(ranks, "flat/auroc/p#calls")
    assert calls == {"ppermute": WORLD - 1, "psum": 1}, calls
    assert _same_on_every_rank(ranks, "flat/auroc/p#bytes")["world"] == (WORLD - 1) * pack * (WORLD - 1) + 24 * 3
    calls = _same_on_every_rank(ranks, "hier/auroc/p#calls")
    assert calls == {"all_gather": 1, "ppermute": 1, "psum": 2}, calls
    hb = _same_on_every_rank(ranks, "hier/auroc/p#bytes")
    assert hb["dcn"] == pack * 1 + 24 and hb["ici"] == 2 * pack * 1 + 24, hb
    assert _same_on_every_rank(ranks, "flat/mrr/skip#calls") == {"all_to_all": 4, "psum": 3}
    assert _same_on_every_rank(ranks, "hier/mrr/skip#calls") == {"all_to_all": 8, "psum": 6}
    assert _same_on_every_rank(ranks, "flat/kendall#calls") == {"ppermute": WORLD - 1, "psum": 1}
    assert _same_on_every_rank(ranks, "flat/curve#calls") == {"ppermute": WORLD - 1, "coalesced_gather": 1}
    assert ranks[0]["grid"] == [[0, 1], [2, 3]]
