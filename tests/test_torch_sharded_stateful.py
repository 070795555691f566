"""Sharded epoch compute through the stateful API, across four real processes (Gloo).

The cases of the JAX package's ``tests/parallel/test_sharded_stateful.py`` and
``tests/parallel/test_mesh2d.py``, in the SPMD form of the port: four ranks
over ``torch.distributed`` (Gloo, a FileStore under ``tmp_path``), each
metric placed with ``device_put(row_sharded())`` (a rank's buffer holds
``capacity // 4`` rows) and fed this rank's block of a seeded global batch
(``batch_sharded()``). Every row-sharded ``compute()`` runs with the port's
``buffer_values``, ``buffer_all_gather`` and ``host_gather`` replaced by a
function that raises, and makes no gather collective. Here, in the pytest
process, the same global batches go through the unsharded port, the JAX
package's metric and sklearn / scipy:

* AUROC (binary, multiclass macro / weighted / none, multilabel macro /
  weighted / micro, partial ``max_fpr``, ``(rows, 1)`` preds), AveragePrecision
  (binary, multiclass, multilabel), ROC / PrecisionRecallCurve (binary,
  multiclass, multilabel), Spearman, Kendall, RetrievalMAP / MRR under every
  empty-query policy, degenerate inputs (``nan``);
* ``reset()`` re-applies the placement; a failed placement does not
  half-promote; ``capacity`` must divide; an overflow raises on every rank,
  and so does one rank's block overflow while the global count fits (the
  documented difference of the SPMD model: the JAX package overflows on the
  global count only); ``regroup_capacity``; the gather fallback warns;
* a collection leaves row-sharded members out of its grouped gather;
  ``dist_sync_on_step`` batch values are global, the others local;
* ``class_sharded`` / ``batch_sharded`` over a 2 x 2 (dp x mp) grid
  (``hierarchical_mesh(slices=2)``) against sklearn and the unsharded
  collection, counts bit for bit, and the pure view's ``sync_state``.

Tolerances: float32 values against the unsharded port and the JAX package
within ``ATOL`` (1e-6) and against sklearn / scipy within ``ATOL_SK`` (1e-5,
the JAX package's own); integer counts and curve thresholds exact.
"""
import json
import os
import subprocess
import sys
import textwrap
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats as st
import torch
from sklearn.metrics import accuracy_score as sk_accuracy
from sklearn.metrics import average_precision_score as sk_ap
from sklearn.metrics import confusion_matrix as sk_confusion_matrix
from sklearn.metrics import f1_score as sk_f1
from sklearn.metrics import precision_recall_curve as sk_prc
from sklearn.metrics import precision_score as sk_precision
from sklearn.metrics import roc_auc_score as sk_auroc
from sklearn.metrics import roc_curve as sk_roc

import metrics_tpu as mt
import metrics_tpu.retrieval as jret
import metrics_tpu_torch as pt
import metrics_tpu_torch.retrieval as pret
from tests.test_torch_faults import plane_hygiene  # noqa: F401  (autouse: every test leaves the process clean)

torch.set_num_threads(1)

_REPO = Path(__file__).resolve().parents[1]
WORLD = 4
ATOL = 1e-6
ATOL_SK = 1e-5

# every case's global batches, made the same way here and in every child:
# name -> (constructor expression, kwargs of device_put, list of global batches)
_DATA = textwrap.dedent("""
    import numpy as np

    def _binary(rng, steps, batch, ties=True):
        out = []
        for _ in range(steps):
            p = rng.rand(batch).astype(np.float32)
            if ties:
                p = np.round(p, 1)
            out.append((p, (rng.rand(batch) > 0.5).astype(np.int64)))
        return out

    def _multiclass(rng, steps, batch, classes, digits=None):
        out = []
        for _ in range(steps):
            logits = rng.rand(batch, classes).astype(np.float32)
            p = logits / logits.sum(-1, keepdims=True)
            if digits is not None:
                p = np.round(p, digits).astype(np.float32)
            out.append((p, rng.randint(0, classes, batch).astype(np.int64)))
        return out

    def _multilabel(rng, batch, labels, digits=None):
        p = rng.rand(batch, labels).astype(np.float32)
        if digits is not None:
            p = np.round(p, digits).astype(np.float32)
        return [(p, (rng.rand(batch, labels) > 0.5).astype(np.int64))]

    def _retrieval(rng, steps, batch, queries, empty=False):
        out = []
        for _ in range(steps):
            i = rng.randint(0, queries, batch).astype(np.int64)
            p = rng.rand(batch).astype(np.float32)
            t = (rng.rand(batch) > (0.5 if empty else 0.6)).astype(np.int64)
            if empty:
                t[i % 7 == 0] = 0
            out.append((i, p, t))
        return out

    def _pairs(rng, steps, batch, noise):
        out = []
        for _ in range(steps):
            p = np.round(rng.rand(batch), 1).astype(np.float32)
            out.append((p, np.round(p + noise * rng.randn(batch), 1).astype(np.float32)))
        return out

    def cases():
        rng = np.random.RandomState(11)
        c = {}
        c["auroc_binary"] = ("AUROC(pos_label=1, capacity=1024)", _binary(rng, 8, 96))
        c["auroc_binary_epoch2"] = ("AUROC(pos_label=1, capacity=1024)", _binary(rng, 1, 512))
        for avg in ("macro", "weighted", None):
            c[f"auroc_mc_{avg}"] = (f"AUROC(num_classes=5, average={avg!r}, capacity=1024)",
                                    _multiclass(rng, 4, 128, 5))
        for avg in ("macro", "weighted", "micro"):
            c[f"auroc_ml_{avg}"] = (f"AUROC(num_classes=3, average={avg!r}, capacity=512)",
                                    _multilabel(rng, 384, 3))
        c["ap_binary"] = ("AveragePrecision(pos_label=1, capacity=1024)", _binary(rng, 6, 128))
        c["ap_mc"] = ("AveragePrecision(num_classes=4, capacity=512)", _multiclass(rng, 1, 256, 4))
        c["ap_ml"] = ("AveragePrecision(num_classes=3, capacity=512)", _multilabel(rng, 256, 3, digits=1))
        c["roc"] = ("ROC(pos_label=1, capacity=1024)", _binary(rng, 6, 96))
        c["prc"] = ("PrecisionRecallCurve(pos_label=1, capacity=512)", _binary(rng, 1, 384))
        c["roc_mc"] = ("ROC(num_classes=4, capacity=512)", _multiclass(rng, 1, 256, 4, digits=2))
        c["prc_ml"] = ("PrecisionRecallCurve(num_classes=3, capacity=512)", _multilabel(rng, 256, 3, digits=1))
        for max_fpr in (0.25, 0.5, 0.9):
            c[f"pauroc_{max_fpr}"] = (f"AUROC(pos_label=1, max_fpr={max_fpr}, capacity=1024)", _binary(rng, 6, 96))
        c["pauroc_degenerate"] = ("AUROC(pos_label=1, max_fpr=0.5, capacity=256)",
                                  [(rng.rand(64).astype(np.float32), np.ones(64, np.int64))])
        c["column_preds"] = ("AUROC(pos_label=1, capacity=512)",
                             [(np.round(rng.rand(256, 1), 1).astype(np.float32),
                               (rng.rand(256) > 0.5).astype(np.int64))])
        c["spearman"] = ("SpearmanCorrcoef(capacity=1024)", _pairs(rng, 6, 96, 0.3))
        c["spearman_epoch2"] = ("SpearmanCorrcoef(capacity=1024)",
                                [(np.round(rng.rand(512), 2).astype(np.float32), rng.rand(512).astype(np.float32))])
        c["kendall"] = ("KendallRankCorrCoef(capacity=512)", _pairs(rng, 4, 64, 0.4))
        c["spearman_constant"] = ("SpearmanCorrcoef(capacity=256)",
                                  [(np.ones(64, np.float32), rng.rand(64).astype(np.float32))])
        c["kendall_constant"] = ("KendallRankCorrCoef(capacity=256)",
                                 [(np.ones(64, np.float32), np.arange(64, dtype=np.float32))])
        c["map"] = ("RetrievalMAP(capacity=1024)", _retrieval(rng, 4, 128, 41))
        for policy in ("skip", "neg", "pos"):
            c[f"mrr_{policy}"] = (f"RetrievalMRR(query_without_relevant_docs={policy!r}, capacity=512)",
                                  _retrieval(rng, 1, 512, 29, empty=True))
        return c

    def class_batches():
        rng = np.random.RandomState(23)
        return [(rng.randint(0, 8, 256).astype(np.int64), rng.randint(0, 8, 256).astype(np.int64))
                for _ in range(4)]
""")
exec(_DATA)  # noqa: S102  (defines cases() and class_batches() here as in the children)

_WORKER = _DATA + textwrap.dedent("""
    import json, sys, traceback, warnings
    import torch, torch.distributed as dist
    sys.path.insert(0, sys.argv[4])
    import metrics_tpu_torch as pt
    import metrics_tpu_torch.core.metric as pmetric
    import metrics_tpu_torch.parallel.buffer as pbuffer
    import metrics_tpu_torch.parallel.sync as psync
    from metrics_tpu_torch import *  # noqa: F403  (the constructor expressions)
    from metrics_tpu_torch.observability import counters
    from metrics_tpu_torch.parallel import batch_sharded, class_sharded, hierarchical_mesh, row_sharded
    from metrics_tpu_torch.retrieval import RetrievalMAP, RetrievalMRR  # noqa: F401

    warnings.simplefilter("always")
    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=4)
    place = batch_sharded()
    res = {}

    def boom(*_a, **_k):
        raise AssertionError("the sharded compute materialized the epoch")

    def host(v):
        if isinstance(v, (tuple, list)):
            return [host(x) for x in v]
        if isinstance(v, dict):
            return {k: host(x) for k, x in v.items()}
        return v.tolist() if isinstance(v, torch.Tensor) else v

    def run(name, fn, poison=True):
        saved = (pbuffer.buffer_values, pbuffer.buffer_all_gather, psync.host_gather, pmetric.host_gather)
        counters.reset()
        counters.enable()
        if poison:
            pbuffer.buffer_values = pbuffer.buffer_all_gather = psync.host_gather = pmetric.host_gather = boom
        caught = []
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                value = host(fn())
        except Exception as err:  # the case's result is the error, checked by the test
            value = {"error": type(err).__name__, "msg": str(err)}
        finally:
            pbuffer.buffer_values, pbuffer.buffer_all_gather, psync.host_gather, pmetric.host_gather = saved
            snap = counters.snapshot()
            counters.disable()
        res[name] = value
        res[name + "#calls"] = snap["calls_by_kind"]
        res[name + "#warnings"] = [str(w.message) for w in caught if "fall back" in str(w.message)]

    def fed(expr, batches, **kw):
        m = eval(expr.replace("capacity=", "device='cpu', capacity="))
        m.device_put(row_sharded())
        for batch in batches:
            m.update(*place(tuple(torch.from_numpy(x) for x in batch)), **kw)
        return m

    all_cases = cases()
    for name, (expr, batches) in all_cases.items():
        if name.endswith("_epoch2"):
            continue
        m = fed(expr, batches)
        res[name + "#local_capacity"] = m._current_state()[next(iter(m._defaults))].capacity
        run(name, m.compute)
        if name + "_epoch2" in all_cases:  # reset keeps the placement; a second epoch
            m.reset()
            res[name + "#reset_capacity"] = m._current_state()[next(iter(m._defaults))].capacity
            for batch in all_cases[name + "_epoch2"][1]:
                m.update(*place(tuple(torch.from_numpy(x) for x in batch)))
            run(name + "_epoch2", m.compute)

    # an overflow raises on every rank: 24 rows a rank into blocks of 16
    binary = all_cases["auroc_binary"][1]
    run("overflow", fed("AUROC(pos_label=1, capacity=64)", binary[:1]).compute)
    # one rank's block overflows while the global count (48) fits the capacity (64)
    m = AUROC(pos_label=1, capacity=64, device="cpu")
    m.device_put(row_sharded())
    p, t = binary[0]
    lo, hi = [0, 20, 32, 40][rank], [20, 32, 40, 48][rank]
    m.update(torch.from_numpy(p[lo:hi]), torch.from_numpy(t[lo:hi]))
    run("block_overflow", m.compute)

    # a placement that rejects the buffer raises before the promotion is committed
    m = AUROC(pos_label=1, capacity=102, device="cpu")
    m.device_put(row_sharded())
    p, t = (torch.from_numpy(x) for x in binary[1])
    try:
        m.update(p[:8], t[:8])
        res["half_promote"] = "no error"
    except ValueError as err:
        res["half_promote"] = str(err)
    res["half_promote#state"] = [isinstance(m._defaults["preds"], list), m.preds == [], m.target == []]
    m.device_put(torch.device("cpu"))
    m.update(p[:8], t[:8])
    run("half_promote_retry", m.compute, poison=False)
    m = AUROC(pos_label=1, capacity=102, device="cpu")
    m.update(p[:8], t[:8])
    try:
        m.device_put(row_sharded())
        res["divisible"] = "no error"
    except ValueError as err:
        res["divisible"] = str(err)

    # skewed query ids overflow the regroup's buckets: the error names the knob
    m = RetrievalMRR(capacity=512, device="cpu")
    m.regroup_capacity = 4
    m.device_put(row_sharded())
    m.update(torch.zeros(128, dtype=torch.long), torch.rand(128), torch.ones(128, dtype=torch.long))
    run("regroup_knob", m.compute)

    # a configuration with no sharded engine warns (rank 0), then takes the gather path
    m = fed("AUROC(num_classes=3, average='micro', capacity=512)", all_cases["auroc_mc_macro"][1][:1])
    m.num_classes = 3
    run("fallback", m.compute, poison=False)

    # a collection: one compute group of two retrieval members, left out of the grouped gather
    col = MetricCollection([RetrievalMAP(device="cpu", capacity=1024), RetrievalMRR(device="cpu", capacity=1024)])
    col.device_put(row_sharded())
    for batch in all_cases["map"][1]:
        col.update(*place(tuple(torch.from_numpy(x) for x in batch)))
    res["collection#groups"] = [list(v) for v in col.compute_groups.values()]
    run("collection", col.compute)

    # forward batch values: global with dist_sync_on_step, local without
    for sync in (True, False):
        m = AUROC(pos_label=1, capacity=1024, device="cpu", dist_sync_on_step=sync)
        m.device_put(row_sharded())
        vals = [m(*place(tuple(torch.from_numpy(x) for x in batch))) for batch in binary[:2]]
        run(f"forward_{sync}", lambda: vals + [m.compute()])

    # class_sharded over 2 x 2 (dp x mp): ici is mp, dcn is dp; a slice sees one dp block
    h = hierarchical_mesh(slices=2)
    dp_place = batch_sharded(h.dcn)

    def class_collection():
        return MetricCollection([Accuracy(device="cpu"), Precision(num_classes=8, average="macro", device="cpu"),
                                 F1(num_classes=8, average="macro", device="cpu"),
                                 ConfusionMatrix(num_classes=8, device="cpu")])

    col = class_collection()
    col.device_put(class_sharded(h))
    cb = class_batches()
    for batch in cb[:3]:
        col.update(*dp_place(tuple(torch.from_numpy(x) for x in batch)))
    res["class2d#states"] = host({k: v for k, v in col["Precision"]._current_state().items()})
    run("class2d", col.compute, poison=False)
    col.reset()
    col.update(*dp_place(tuple(torch.from_numpy(x) for x in cb[3])))
    run("class2d_epoch2", col.compute, poison=False)
    pure = col.pure()
    state = pure.update(pure.init(), *dp_place(tuple(torch.from_numpy(x) for x in cb[0])))
    run("class2d_pure", lambda: pure.compute(pure.sync(state)), poison=False)
    try:
        col.sync_state(state, deferred=True)
        res["class2d_deferred"] = "no error"
    except ValueError as err:
        res["class2d_deferred"] = str(err)
    try:
        batch_sharded()(torch.zeros(10))
        res["batch_error"] = "no error"
    except ValueError as err:
        res["batch_error"] = str(err)
    json.dump(res, open(out, "w"))
    dist.destroy_process_group()
""")


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_stateful")
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


CASES = cases()  # noqa: F821  (defined by exec(_DATA))


def _same(ranks, key):
    first = ranks[0][key]
    for r in ranks[1:]:
        np.testing.assert_equal(r[key], first, err_msg=key)  # nan equals nan here
    return first


def _concat(batches):
    return tuple(np.concatenate(parts) for parts in zip(*batches))


def _unsharded(expr, batches, package):
    """The value of the unsharded metric of ``package`` fed the global batches."""
    if package is pt:
        scope = {**vars(pt), **vars(pret)}
        m = eval(expr.replace("capacity=", "device='cpu', capacity="), scope)  # noqa: S307
        for batch in batches:
            m.update(*(torch.from_numpy(x) for x in batch))
    else:
        m = eval(expr, {**vars(mt), **vars(jret)})  # noqa: S307
        for batch in batches:
            m.update(*(jnp.asarray(x) for x in batch))
    return m.compute()


def _host(v):
    if isinstance(v, (tuple, list)):
        return [_host(x) for x in v]
    return np.asarray(v, dtype=np.float64).tolist()


def _sk_scalar(name, batches):
    if name.startswith(("map", "mrr")):
        return None  # the unsharded port and the JAX package hold retrieval
    p, t = _concat(batches)
    if name.startswith("auroc_binary") or name == "column_preds":
        return sk_auroc(t, p.reshape(len(t), -1)[:, 0])
    if name.startswith("auroc_mc"):
        avg = name.rsplit("_", 1)[1]
        if avg == "None":
            return [sk_auroc((t == c).astype(int), p[:, c]) for c in range(p.shape[1])]
        return sk_auroc(t, p, multi_class="ovr", average=avg, labels=np.arange(p.shape[1]))
    if name.startswith("auroc_ml"):
        return sk_auroc(t, p, average=name.rsplit("_", 1)[1])
    if name == "ap_binary":
        return sk_ap(t, p)
    if name == "ap_mc":
        return [sk_ap((t == c).astype(int), p[:, c]) for c in range(p.shape[1])]
    if name == "ap_ml":
        return [sk_ap(t[:, c], p[:, c]) for c in range(p.shape[1])]
    if name.startswith("pauroc_0"):
        return sk_auroc(t, p, max_fpr=float(name.split("_")[1]))
    if name.startswith("spearman"):
        return st.spearmanr(p, t).statistic
    if name == "kendall":
        return st.kendalltau(p, t).statistic
    return None


SCALARS = [n for n in CASES if not n.startswith(("roc", "prc"))]


@pytest.mark.parametrize("name", SCALARS)
def test_row_sharded_scalar_equals_unsharded_and_jax(ranks, name):
    """Every scalar case: the same value on every rank, within ATOL of the
    unsharded port and the JAX package's metric on the global batches and
    within ATOL_SK of sklearn / scipy; no gather collective at ``compute()``
    (the gather functions raised if called); degenerate inputs ``nan``.
    Multilabel AP has no gather path in either package (both raise on its
    layout), so sklearn alone holds its sharded value; a degenerate partial
    AUC raises on both gather paths and is ``nan`` on the ring, as in the
    JAX package's sharded engine."""
    expr, batches = CASES[name]
    got = np.asarray(_same(ranks, name), dtype=np.float64)
    calls = _same(ranks, name + "#calls")
    # partial AUC takes the curve engine: one gather of the finished curve points, never the raw rows
    allowed = {"coalesced_gather": 1} if name.startswith("pauroc") else {}
    assert {k: v for k, v in calls.items() if k in ("all_gather", "coalesced_gather", "process_allgather")} \
        == allowed, calls
    rejected = {"ap_ml": "same number of dimensions", "pauroc_degenerate": "No negative samples"}
    if name in rejected:
        # multilabel AP has only the sharded engine, and the gather path checks a degenerate target
        # eagerly: both packages' gather paths raise alike, while the sharded engine gives its value or nan
        for package in (pt, mt):
            with pytest.raises(ValueError, match=rejected[name]):
                _unsharded(expr, batches, package)
    else:
        np.testing.assert_allclose(got, _host(_unsharded(expr, batches, pt)), atol=ATOL, equal_nan=True)
        np.testing.assert_allclose(got, _host(_unsharded(expr, batches, mt)), atol=ATOL, equal_nan=True)
    want = _sk_scalar(name, batches)
    if want is not None:
        np.testing.assert_allclose(got, want, atol=ATOL_SK)
    if name.endswith(("degenerate", "constant")):
        assert np.isnan(got)
    if "capacity=1024" in expr and not name.endswith("epoch2"):
        assert _same(ranks, name + "#local_capacity") == 256
    if name + "#reset_capacity" in ranks[0]:
        assert _same(ranks, name + "#reset_capacity") == 256  # reset re-applied the placement


@pytest.mark.parametrize("name", ["roc", "prc", "roc_mc", "prc_ml"])
def test_row_sharded_curves(ranks, name):
    """ROC / PrecisionRecallCurve vectors on the ring: the distinct thresholds
    exactly sklearn's, the rates within ATOL_SK, padded to the global capacity
    and equal to the unsharded port's padded curves within ATOL."""
    expr, batches = CASES[name]
    p, t = _concat(batches)
    got = _same(ranks, name)
    plain = _host(_unsharded(expr, batches, pt))
    for g, w in zip(got, plain):
        np.testing.assert_allclose(np.asarray(g, dtype=np.float64), w, atol=ATOL, equal_nan=True)
    a, b, th, count = (np.asarray(x) for x in got)
    if name == "roc":
        c = int(count)
        sk_fpr, sk_tpr, sk_th = sk_roc(t, p, drop_intermediate=False)
        np.testing.assert_allclose(a[:c], sk_fpr, atol=ATOL_SK)
        np.testing.assert_allclose(b[:c], sk_tpr, atol=ATOL_SK)
        np.testing.assert_array_equal(th[1:c], sk_th[1:].astype(np.float32))
        assert a.shape[0] == 1024 + 1
    elif name == "prc":
        c = int(count)
        sk_p, sk_r, sk_t = sk_prc(t, p)
        np.testing.assert_allclose(a[: c + 1], sk_p, atol=ATOL_SK)
        np.testing.assert_allclose(b[: c + 1], sk_r, atol=ATOL_SK)
        np.testing.assert_array_equal(th[:c], sk_t)
    else:
        for c in range(p.shape[1]):
            k = int(count[c])
            y = (t == c).astype(int) if t.ndim == 1 else t[:, c]
            if name == "roc_mc":
                sk_fpr, sk_tpr, _ = sk_roc(y, p[:, c], drop_intermediate=False)
                np.testing.assert_allclose(a[c, :k], sk_fpr, atol=ATOL_SK)
                np.testing.assert_allclose(b[c, :k], sk_tpr, atol=ATOL_SK)
            else:
                sk_p, sk_r, sk_t = sk_prc(y, p[:, c])
                np.testing.assert_allclose(a[c, :k + 1], sk_p, atol=ATOL_SK)
                np.testing.assert_array_equal(th[c, :k], sk_t)


@pytest.mark.parametrize("name", ["overflow", "block_overflow"])
def test_overflow_raises_on_every_rank(ranks, name):
    """24 rows a rank into blocks of 16 raise ``BufferOverflowError`` on every
    rank; so does one rank's 20 rows while the global 48 fit the capacity of 64
    (the SPMD model's difference: a rank fills its own block)."""
    for r in ranks:
        assert r[name]["error"] == "BufferOverflowError" and "overflowed" in r[name]["msg"], r[name]


def test_placement_errors_and_half_promotion(ranks):
    """A capacity of 102 does not divide by 4: the promoting update raises
    ``ValueError`` and leaves both cat states unpromoted lists; placing on the
    CPU device then lets the same metric update and compute (the gather path,
    equal to sklearn over the 4 ranks' rows); ``device_put(row_sharded())``
    after an update raises too; a batch of 10 rows does not split in 4."""
    p, t = (x[:8] for x in CASES["auroc_binary"][1][1])
    for r in ranks:
        assert "divisible" in r["half_promote"] and r["half_promote#state"] == [True, True, True]
        assert "divisible" in r["divisible"] and "not divisible" in r["batch_error"]
    np.testing.assert_allclose(_same(ranks, "half_promote_retry"), sk_auroc(np.tile(t, 4), np.tile(p, 4)),
                               atol=ATOL_SK)


def test_regroup_capacity_and_fallback(ranks):
    """Skewed query ids overflow 4-row buckets: ``RuntimeError`` naming
    ``regroup_capacity`` on every rank. A multiclass micro AUROC has no
    sharded engine: rank 0 warns of the gathered fallback, then the gather
    path raises its own average error on every rank."""
    for r in ranks:
        assert r["regroup_knob"]["error"] == "RuntimeError" and "regroup_capacity" in r["regroup_knob"]["msg"]
        assert r["fallback"]["error"] == "ValueError" and "average" in r["fallback"]["msg"]
    assert any("fall back to the gathered" in w for w in ranks[0]["fallback#warnings"])


def test_collection_leaves_sharded_members_out_of_grouped_gather(ranks):
    """RetrievalMAP and RetrievalMRR form one compute group, yet their
    row-sharded states take no grouped gather: each regroups on its own (no
    gather collective, 4 ``all_to_all`` a member), values within ATOL of the
    unsharded port."""
    assert _same(ranks, "collection#groups") == [["RetrievalMAP", "RetrievalMRR"]]
    calls = _same(ranks, "collection#calls")
    assert calls.get("all_to_all") == 8 and "all_gather" not in calls, calls
    got = _same(ranks, "collection")
    batches = CASES["map"][1]
    for key, expr in (("RetrievalMAP", "RetrievalMAP(capacity=1024)"), ("RetrievalMRR", "RetrievalMRR(capacity=1024)")):
        np.testing.assert_allclose(got[key], float(_unsharded(expr, batches, pt)), atol=ATOL)


def test_forward_batch_values(ranks):
    """With ``dist_sync_on_step`` a forward's value is the global batch's,
    through the ring over the deltas; without it, the rank's own block's."""
    batches = CASES["auroc_binary"][1][:2]
    got = _same(ranks, "forward_True")
    for step, (p, t) in enumerate(batches):
        np.testing.assert_allclose(got[step], sk_auroc(t, p), atol=ATOL_SK)
    np.testing.assert_allclose(got[2], sk_auroc(*_concat(batches)[::-1]), atol=ATOL_SK)
    for r, res in enumerate(ranks):
        for step, (p, t) in enumerate(batches):
            block = slice(r * 24, (r + 1) * 24)
            np.testing.assert_allclose(res["forward_False"][step], sk_auroc(t[block], p[block]), atol=ATOL_SK)


def test_class_sharded_2x2(ranks):
    """``class_sharded`` over 2 x 2: dp blocks of each batch by
    ``batch_sharded(h.dcn)``; the epoch values equal sklearn (ATOL) and the
    confusion matrix bit for bit, the same on every rank; a class state syncs
    its 4-class block over dp and gathers the blocks over mp (one
    ``all_gather`` an epoch sync of a group); the local states stay full; the
    placement survives ``reset()``; the pure view syncs whole states; no
    deferred sync."""
    cb = class_batches()  # noqa: F821
    p = np.concatenate([b[0] for b in cb[:3]])
    t = np.concatenate([b[1] for b in cb[:3]])
    got = _same(ranks, "class2d")
    np.testing.assert_allclose(got["Accuracy"], sk_accuracy(t, p), atol=ATOL)
    np.testing.assert_allclose(got["Precision"], sk_precision(t, p, average="macro", zero_division=0), atol=ATOL)
    np.testing.assert_allclose(got["F1"], sk_f1(t, p, average="macro", zero_division=0), atol=ATOL)
    np.testing.assert_array_equal(got["ConfusionMatrix"], sk_confusion_matrix(t, p, labels=list(range(8))))
    calls = _same(ranks, "class2d#calls")
    assert calls["all_gather"] == 2, calls  # the Precision / F1 group and ConfusionMatrix
    assert len(ranks[0]["class2d#states"]["tp"]) == 8
    plain = pt.MetricCollection([pt.Accuracy(device="cpu"), pt.Precision(num_classes=8, average="macro", device="cpu"),
                                 pt.F1(num_classes=8, average="macro", device="cpu"),
                                 pt.ConfusionMatrix(num_classes=8, device="cpu")])
    for b in cb[:3]:
        plain.update(*(torch.from_numpy(x) for x in b))
    want = plain.compute()
    np.testing.assert_array_equal(got["ConfusionMatrix"], want["ConfusionMatrix"].numpy())
    np.testing.assert_allclose(got["Precision"], float(want["Precision"]), atol=ATOL)
    np.testing.assert_allclose(_same(ranks, "class2d_epoch2")["Accuracy"], sk_accuracy(cb[3][1], cb[3][0]), atol=ATOL)
    pure = _same(ranks, "class2d_pure")
    np.testing.assert_allclose(pure["Precision"], sk_precision(cb[0][1], cb[0][0], average="macro", zero_division=0),
                               atol=ATOL)
    np.testing.assert_array_equal(pure["ConfusionMatrix"], sk_confusion_matrix(cb[0][1], cb[0][0], labels=list(range(8))))
    assert "deferred" in ranks[0]["class2d_deferred"]


# ----------------------------------------------------------- in one process
def test_placement_policies_in_one_process():
    """Outside a process group the world is this process: ``row_sharded``
    keeps the whole capacity, ``batch_sharded`` the whole batch, the
    dispatch runs the engine with no collective; ``class_sharded`` needs a
    ``MeshHierarchy``; ``device_put`` of a device moves the states and keeps
    them there through ``reset()``; an unplaced metric owns no sync."""
    m = pt.AUROC(pos_label=1, capacity=64, device="cpu")
    assert not m._states_own_sync()
    m.device_put(pt.parallel.row_sharded())
    p, t = torch.rand(40), (torch.rand(40) > 0.5).long()
    m.update(p, t)
    assert m.preds.capacity == 64 and m._states_own_sync()
    np.testing.assert_allclose(float(m.compute()), sk_auroc(t.numpy(), p.numpy()), atol=ATOL_SK)
    assert torch.equal(pt.parallel.batch_sharded()((p, {"t": t}))[1]["t"], t)
    with pytest.raises(TypeError, match="MeshHierarchy"):
        pt.parallel.class_sharded(None)
    col = pt.MetricCollection([pt.Accuracy(device="cpu"), pt.SpearmanCorrcoef(device="cpu", capacity=32)])
    col.device_put(torch.device("cpu"))
    col.reset()
    assert col["SpearmanCorrcoef"].preds_all.data.device.type == "cpu" and col["Accuracy"].device.type == "cpu"


_POS_LABEL_WARNING = "`pos_label` automatically set 1."


@pytest.mark.parametrize("name", ["AveragePrecision", "ROC", "PrecisionRecallCurve"])
def test_sharded_binary_pos_label_default_warns_as_the_gather_path(name):
    """Binary AP / ROC / PRC without a ``pos_label``: the gather path warns
    (at the update, which records ``pos_label = 1``); the sharded dispatch
    gives the same warning for a metric whose ``pos_label`` is still unset at
    ``compute()``, and the value of ``pos_label = 1``."""
    from metrics_tpu_torch.utils import prints as pprints

    rng = np.random.default_rng(31)
    p = torch.from_numpy(rng.random(40).astype(np.float32))
    t = torch.from_numpy(rng.integers(0, 2, 40))

    def caught(fn):
        pprints._WARN_ONCE_SEEN.discard(_POS_LABEL_WARNING)
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            out = fn()
        return out, [str(w.message) for w in seen if "pos_label" in str(w.message)]

    gathered = getattr(pt, name)(capacity=64, device="cpu")
    _, gather_warnings = caught(lambda: gathered.update(p, t))
    want = gathered.compute()
    sharded = getattr(pt, name)(capacity=64, device="cpu")
    sharded.device_put(pt.parallel.row_sharded())
    sharded.update(p, t)
    sharded.pos_label = None  # unset at compute(): the dispatch's own default applies
    got, shard_warnings = caught(sharded.compute)
    assert gather_warnings == shard_warnings == [_POS_LABEL_WARNING]
    assert sharded.pos_label is None
    for a, b in zip(got if isinstance(got, tuple) else (got,), want if isinstance(want, tuple) else (want,)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=ATOL)
