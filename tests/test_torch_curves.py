"""The exact curve family and dice: the port against the JAX package.

The same numpy inputs (from a seed) go through ``metrics_tpu`` and
``metrics_tpu_torch`` (``device="cpu"``):

* every functional (``auroc``, ``average_precision``, ``roc``,
  ``precision_recall_curve``, ``auc``, ``dice_score``) and the static-shape
  kernels of ``curve_static``, for binary, multiclass and multilabel input,
  every ``average``, ``max_fpr``, ``sample_weights``, tied scores, NaN scores
  and -0.0 / +0.0;
* the modules over several batches, in list mode and ``capacity`` mode;
* PaddedBuffer overflow under the ``error`` and ``warn_drop`` policies;
* the error messages of the value checks and of argument validation.

Thresholds and valid counts are exact; AUROC / AP agree to rtol 1e-5 and
curve points to rtol 1e-6, since the float32 sums run in another order.
"""
import pickle
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt
import metrics_tpu.functional as mtf
import metrics_tpu_torch as pt
import metrics_tpu_torch.functional as ptf
from metrics_tpu.functional.classification import curve_static as jax_static
from metrics_tpu.parallel import buffer as jax_buffer
from metrics_tpu_torch.functional.classification import curve_static as port_static
from metrics_tpu_torch.parallel import buffer as port_buffer
from metrics_tpu_torch.utils.exceptions import BufferOverflowError

torch.set_num_threads(1)

N, C = 96, 4
RTOL_SCORE = 1e-5  # AUROC / AP: float32 sums of N terms in another order
RTOL_CURVE = 1e-6  # curve points: one float32 division each


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def _data(kind, seed, n=N):
    """Scores on a coarse grid (ties), with NaN and signed zeros in ``binary_edges``."""
    rng = np.random.RandomState(seed)
    if kind in ("binary", "binary_edges"):
        p = (rng.randint(0, 25, n) / 25).astype(np.float32)
        if kind == "binary_edges":
            p[:4] = np.nan
            p[4:10] = -0.0
            p[10:16] = 0.0
        return p, rng.randint(0, 2, n)
    if kind == "binary_ints":
        return rng.randint(-5, 20, n), rng.randint(0, 2, n)  # integer scores (no input checks on this path)
    if kind == "multiclass":
        logits = rng.randint(0, 6, (n, C)).astype(np.float32)
        probs = np.exp(logits) / np.exp(logits).sum(1, keepdims=True)
        return probs.astype(np.float32), rng.randint(0, C, n)
    if kind == "multilabel":
        return (rng.randint(0, 20, (n, C)) / 20).astype(np.float32), rng.randint(0, 2, (n, C))
    raise ValueError(kind)


def _weights(seed, n=N):
    return np.random.RandomState(seed + 100).rand(n).astype(np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def _assert_same(got, want, rtol):
    """Recursive comparison: tuples / lists element by element; integer arrays exact."""
    if isinstance(want, (tuple, list)):
        assert isinstance(got, (tuple, list)) and len(got) == len(want), (type(got), len(got), len(want))
        for g, w in zip(got, want):
            _assert_same(g, w, rtol)
        return
    g, w = _np(got), _np(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    if np.issubdtype(w.dtype, np.integer) or np.issubdtype(w.dtype, np.bool_):
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-7, equal_nan=True)


def _both(fn_port, fn_jax, arrays, **kw):
    port_kw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    jax_kw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    return (fn_port(*(torch.from_numpy(a) for a in arrays), **port_kw),
            fn_jax(*(jnp.asarray(a) for a in arrays), **jax_kw))


# ------------------------------------------------------------------ functionals
_SCORE_CASES = [
    ("binary", {"pos_label": 1}),
    ("binary_edges", {"pos_label": 1}),
    ("binary", {"pos_label": 0}),
    ("binary", {"pos_label": 1, "weights": True}),
    ("binary_edges", {"pos_label": 1, "weights": True}),
    ("multiclass", {"num_classes": C, "average": None}),
    ("multiclass", {"num_classes": C, "average": "macro"}),
    ("multiclass", {"num_classes": C, "average": "weighted"}),
    ("multiclass", {"num_classes": C, "average": "macro", "weights": True}),
    ("multilabel", {"num_classes": C, "average": None}),
    ("multilabel", {"num_classes": C, "average": "macro"}),
    ("multilabel", {"num_classes": C, "average": "weighted"}),
    ("multilabel", {"num_classes": C, "average": "micro"}),
]


def _kw(kind, args, seed):
    kw = dict(args)
    if kw.pop("weights", False):
        kw["sample_weights"] = _weights(seed)
    return kw


@pytest.mark.parametrize("kind,args", _SCORE_CASES)
def test_auroc_matches_jax(kind, args):
    arrays = _data(kind, 1)
    got, want = _both(ptf.auroc, mtf.auroc, arrays, **_kw(kind, args, 1))
    _assert_same(got, want, RTOL_SCORE)


@pytest.mark.parametrize("kind", ["binary", "binary_edges"])
@pytest.mark.parametrize("max_fpr", [0.05, 0.3, 0.8, 1.0])
def test_partial_auroc_matches_jax(kind, max_fpr):
    got, want = _both(ptf.auroc, mtf.auroc, _data(kind, 2), pos_label=1, max_fpr=max_fpr)
    _assert_same(got, want, RTOL_SCORE)


@pytest.mark.parametrize("kind,args", [
    ("binary", {"pos_label": 1}),
    ("binary_edges", {"pos_label": 1}),
    ("binary_ints", {"pos_label": 1}),
    ("binary", {"pos_label": 0, "weights": True}),
    ("binary_edges", {"pos_label": 1, "weights": True}),
    ("multiclass", {"num_classes": C}),
    ("multiclass", {"num_classes": C, "weights": True}),
])
def test_average_precision_matches_jax(kind, args):
    got, want = _both(ptf.average_precision, mtf.average_precision, _data(kind, 3), **_kw(kind, args, 3))
    _assert_same(got, want, RTOL_SCORE)


@pytest.mark.parametrize("fn", ["roc", "precision_recall_curve"])
@pytest.mark.parametrize("kind,args", [
    ("binary", {"pos_label": 1}),
    ("binary_edges", {"pos_label": 1}),
    ("binary", {"pos_label": 1, "weights": True}),
    ("binary_edges", {"pos_label": 0, "weights": True}),
    ("binary_ints", {"pos_label": 1}),
    ("multiclass", {"num_classes": C}),
    ("multiclass", {"num_classes": C, "weights": True}),
    ("multilabel", {"num_classes": C}),
])
def test_curves_match_jax(fn, kind, args):
    arrays, kw = _data(kind, 4), _kw(kind, args, 4)
    if fn == "precision_recall_curve" and kind == "multilabel":
        # the per-class sweep hands a 1-D column with the 2-D target to the binary path: both raise
        msgs = []
        for impl, conv in ((getattr(ptf, fn), torch.from_numpy), (getattr(mtf, fn), jnp.asarray)):
            with pytest.raises(ValueError) as err:
                impl(*(conv(a) for a in arrays), **kw)
            msgs.append(str(err.value))
        assert msgs[0] == msgs[1]
        return
    got, want = _both(getattr(ptf, fn), getattr(mtf, fn), arrays, **kw)
    _assert_same(got, want, RTOL_CURVE)


def test_signed_zeros_do_not_change_the_result():
    """-0.0 and +0.0 are one tie run: the order they sort in changes no count."""
    p, y = _data("binary_edges", 5)
    flipped = p.copy()
    flipped[4:16] = -flipped[4:16]  # -0.0 <-> +0.0
    for fn in (ptf.auroc, ptf.average_precision):
        a = fn(torch.from_numpy(p), torch.from_numpy(y), pos_label=1)
        b = fn(torch.from_numpy(flipped), torch.from_numpy(y), pos_label=1)
        assert torch.equal(a, b)
    for fn in (ptf.roc, ptf.precision_recall_curve):
        for a, b in zip(fn(torch.from_numpy(p), torch.from_numpy(y), pos_label=1),
                        fn(torch.from_numpy(flipped), torch.from_numpy(y), pos_label=1)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("case", ["increasing", "decreasing", "reorder", "ints"])
def test_auc_matches_jax(case):
    rng = np.random.RandomState(6)
    x, y = np.sort(rng.rand(20)).astype(np.float32), rng.rand(20).astype(np.float32)
    kw = {}
    if case == "decreasing":
        x = x[::-1].copy()
    elif case == "reorder":
        rng.shuffle(x)
        kw["reorder"] = True
    elif case == "ints":
        x, y = np.arange(6), np.array([0, 1, 2, 2, 3, 1])
    got, want = _both(ptf.auc, mtf.auc, (x, y), **kw)
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL_CURVE)


@pytest.mark.parametrize("bg", [False, True])
@pytest.mark.parametrize("reduction", ["elementwise_mean", "sum", "none"])
@pytest.mark.parametrize("nan_score,no_fg_score", [(0.0, 0.0), (-1.0, 0.5)])
def test_dice_score_matches_jax(bg, reduction, nan_score, no_fg_score):
    p, y = _data("multiclass", 7)
    y[y == 3] = 2  # class 3 has no foreground: no_fg_score applies
    got, want = _both(ptf.dice_score, mtf.dice_score, (p, y), bg=bg, reduction=reduction,
                      nan_score=nan_score, no_fg_score=no_fg_score)
    _assert_same(got, want, RTOL_CURVE)


# ----------------------------------------------------------- static kernels
@pytest.mark.parametrize("kernel", ["roc_padded", "precision_recall_curve_padded"])
@pytest.mark.parametrize("kind", ["binary", "binary_edges", "binary_ints", "multiclass", "multilabel"])
@pytest.mark.parametrize("ghost_rows", [0, 17])
def test_padded_kernels_match_jax(kernel, kind, ghost_rows):
    p, y = _data(kind, 8)
    mask = np.arange(N) < N - ghost_rows
    got = getattr(port_static, kernel)(torch.from_numpy(p), torch.from_numpy(y), None, 1, torch.from_numpy(mask))
    want = getattr(jax_static, kernel)(jnp.asarray(p), jnp.asarray(y), None, 1, jnp.asarray(mask))
    _assert_same(got, want, RTOL_CURVE)


@pytest.mark.parametrize("n", [5, 1024, 1025, 5000])
def test_static_scores_match_jax_across_scan_blocks(n):
    """Lengths around the reverse-cummin block (1,024) give the JAX package's AUROC / AP."""
    rng = np.random.RandomState(n)
    p, y, w = (rng.randint(0, 300, n) / 300).astype(np.float32), rng.randint(0, 2, n), rng.rand(n).astype(np.float32)
    for port_fn, jax_fn in ((port_static.binary_auroc_static, jax_static.binary_auroc_static),
                            (port_static.binary_average_precision_static, jax_static.binary_average_precision_static)):
        for weights in (None, w):
            got = port_fn(torch.from_numpy(p), torch.from_numpy(y), None if weights is None else torch.from_numpy(weights))
            want = jax_fn(jnp.asarray(p), jnp.asarray(y), None if weights is None else jnp.asarray(weights))
            _assert_same(got, want, RTOL_SCORE)


@pytest.mark.parametrize("shape", [(7,), (3, 1024), (2, 3000), (4097,)])
def test_blocked_reverse_cummin_equals_one_scan(shape):
    x = torch.from_numpy(np.random.RandomState(9).rand(*shape).astype(np.float32))
    want = torch.flip(torch.cummin(torch.flip(x, [-1]), -1).values, [-1])
    assert torch.equal(port_static._reverse_cummin(x), want)


def test_sorted_counts_run_ends_match_jax():
    p, y = _data("binary_edges", 10)
    mask = np.arange(N) < N - 9
    got = port_static._sorted_counts(torch.from_numpy(p), torch.from_numpy(y), None, torch.from_numpy(mask))
    want = jax_static._sorted_counts(jnp.asarray(p), jnp.asarray(y), None, jnp.asarray(mask))
    _assert_same(got, want, 0)


# --------------------------------------------------------------------- modules
_MODULES = [
    ("AUROC", "binary", {"pos_label": 1}),
    ("AUROC", "binary", {"pos_label": 1, "max_fpr": 0.4}),
    ("AUROC", "multiclass", {"num_classes": C, "average": "weighted"}),
    ("AUROC", "multilabel", {"num_classes": C, "average": "micro"}),
    ("AveragePrecision", "binary", {"pos_label": 1}),
    ("AveragePrecision", "multiclass", {"num_classes": C}),
    ("ROC", "binary", {"pos_label": 1}),
    ("ROC", "multiclass", {"num_classes": C}),
    ("ROC", "multilabel", {"num_classes": C}),
    ("PrecisionRecallCurve", "binary", {"pos_label": 1}),
    ("PrecisionRecallCurve", "multiclass", {"num_classes": C}),
]


@pytest.mark.parametrize("capacity", [None, 512])
@pytest.mark.parametrize("name,kind,args", _MODULES)
def test_modules_over_batches_match_jax(name, kind, args, capacity):
    ref = getattr(mt, name)(capacity=capacity, **args)
    port = getattr(pt, name)(capacity=capacity, device="cpu", **args)
    for step in range(3):
        p, y = _data(kind, 20 + step, n=40 + 8 * step)
        _assert_same(port(torch.from_numpy(p), torch.from_numpy(y)), ref(jnp.asarray(p), jnp.asarray(y)), RTOL_SCORE)
    if capacity is not None:
        assert isinstance(port.preds, port_buffer.PaddedBuffer) and int(port.preds.count) == 40 + 48 + 56
    _assert_same(port.compute(), ref.compute(), RTOL_SCORE)
    port.reset()
    ref.reset()
    p, y = _data(kind, 30)
    port.update(torch.from_numpy(p), torch.from_numpy(y))
    ref.update(jnp.asarray(p), jnp.asarray(y))
    _assert_same(port.compute(), ref.compute(), RTOL_SCORE)


def test_auc_module_matches_jax():
    ref, port = mt.AUC(reorder=True), pt.AUC(reorder=True, device="cpu")
    rng = np.random.RandomState(11)
    for _ in range(3):
        x, y = rng.rand(10).astype(np.float32), rng.rand(10).astype(np.float32)
        _assert_same(port(torch.from_numpy(x), torch.from_numpy(y)), ref(jnp.asarray(x), jnp.asarray(y)), RTOL_CURVE)
    _assert_same(port.compute(), ref.compute(), RTOL_CURVE)


def test_list_and_capacity_modes_agree():
    lists = pt.MetricCollection([pt.AUROC(pos_label=1, device="cpu"), pt.AveragePrecision(pos_label=1, device="cpu")])
    bufs = pt.MetricCollection([pt.AUROC(pos_label=1, capacity=300, device="cpu"),
                                pt.AveragePrecision(pos_label=1, capacity=300, device="cpu")])
    for step in range(3):
        p, y = _data("binary_edges", 40 + step, n=64)
        for a, b in zip(lists(torch.from_numpy(p), torch.from_numpy(y)).values(),
                        bufs(torch.from_numpy(p), torch.from_numpy(y)).values()):
            assert torch.equal(a, b)
    for a, b in zip(lists.compute().values(), bufs.compute().values()):
        assert torch.equal(a, b)


# -------------------------------------------------------------------- overflow
@pytest.mark.parametrize("policy", ["error", "warn_drop"])
def test_overflow_policy_matches_jax(policy):
    old_port, old_jax = port_buffer.set_overflow_policy(policy), jax_buffer.set_overflow_policy(policy)
    try:
        ref, port = mt.AUROC(pos_label=1, capacity=50), pt.AUROC(pos_label=1, capacity=50, device="cpu")
        for step in range(2):
            p, y = _data("binary", 50 + step, n=40)
            ref.update(jnp.asarray(p), jnp.asarray(y))
            port.update(torch.from_numpy(p), torch.from_numpy(y))
        assert int(port.preds.count) == 80 and port.preds.capacity == 50
        if policy == "error":
            messages = []
            for m, exc in ((port, BufferOverflowError), (ref, Exception)):
                with pytest.raises(exc) as err:
                    m.compute()
                messages.append(str(err.value))
            assert messages[0] == messages[1]
        else:
            with warnings.catch_warnings(record=True):
                warnings.simplefilter("always")
                _assert_same(port.compute(), ref.compute(), RTOL_SCORE)
            # the kept rows are the first 50 appended
            p0, y0 = _data("binary", 50, n=40)
            p1, y1 = _data("binary", 51, n=40)
            want = ptf.auroc(torch.from_numpy(np.concatenate([p0, p1[:10]])),
                             torch.from_numpy(np.concatenate([y0, y1[:10]])), pos_label=1)
            assert torch.equal(port.compute(), want)
    finally:
        port_buffer.set_overflow_policy(old_port)
        jax_buffer.set_overflow_policy(old_jax)


def test_padded_curve_overflow_message_matches_jax():
    ref, port = mt.ROC(pos_label=1, capacity=30), pt.ROC(pos_label=1, capacity=30, device="cpu")
    p, y = _data("binary", 52, n=40)
    ref.update(jnp.asarray(p), jnp.asarray(y))
    port.update(torch.from_numpy(p), torch.from_numpy(y))
    messages = []
    for m in (port, ref):
        with pytest.raises(RuntimeError) as err:
            m.compute()
        messages.append(str(err.value))
    assert messages[0] == messages[1]


def test_buffer_ops_match_jax():
    rng = np.random.RandomState(12)
    a, b = rng.rand(5, 2).astype(np.float32), rng.rand(4, 2).astype(np.float32)
    jb = jax_buffer.buffer_merge(jax_buffer.buffer_append(jax_buffer.buffer_init(8, (2,)), jnp.asarray(a)),
                                 jax_buffer.buffer_append(jax_buffer.buffer_init(6, (2,)), jnp.asarray(b)))
    pb = port_buffer.buffer_merge(port_buffer.buffer_append(port_buffer.buffer_init(8, (2,)), torch.from_numpy(a)),
                                  port_buffer.buffer_append(port_buffer.buffer_init(6, (2,)), torch.from_numpy(b)))
    _assert_same(pb.data, jb.data, 0)
    assert int(pb.count) == int(jb.count) == 9
    stack, counts = rng.rand(3, 4, 2).astype(np.float32), np.array([2, 0, 4])
    _assert_same(port_buffer.buffer_compact_gathered(torch.from_numpy(stack), torch.from_numpy(counts)).data,
                 jax_buffer.buffer_compact_gathered(jnp.asarray(stack), jnp.asarray(counts)).data, 0)


# ------------------------------------------------------------- error messages
def _raises_same(call_port, call_jax, exc=ValueError):
    messages = []
    for call in (call_port, call_jax):
        with pytest.raises(exc) as err:
            call()
        messages.append(str(err.value))
    assert messages[0] == messages[1]


@pytest.mark.parametrize("target", [np.ones(8, np.int64), np.zeros(8, np.int64)])
@pytest.mark.parametrize("fn", ["auroc", "roc"])
def test_pos_neg_check_messages_match_jax(fn, target):
    p = np.linspace(0, 1, 8).astype(np.float32)
    _raises_same(lambda: getattr(ptf, fn)(torch.from_numpy(p), torch.from_numpy(target), pos_label=1),
                 lambda: getattr(mtf, fn)(jnp.asarray(p), jnp.asarray(target), pos_label=1))


def test_multiclass_pos_neg_check_message_matches_jax():
    p, y = _data("multiclass", 13)
    y[y == 2] = 1  # class 2 never occurs: no positives
    _raises_same(lambda: ptf.auroc(torch.from_numpy(p), torch.from_numpy(y), num_classes=C),
                 lambda: mtf.auroc(jnp.asarray(p), jnp.asarray(y), num_classes=C))


@pytest.mark.parametrize("kwargs", [{"max_fpr": 1.5}, {"max_fpr": 0}, {"average": "samples"}])
def test_auroc_argument_messages_match_jax(kwargs):
    _raises_same(lambda: pt.AUROC(device="cpu", **kwargs), lambda: mt.AUROC(**kwargs))


def test_functional_argument_messages_match_jax():
    p, y = _data("multiclass", 14)
    _raises_same(lambda: ptf.auroc(torch.from_numpy(p), torch.from_numpy(y), num_classes=C, max_fpr=0.5),
                 lambda: mtf.auroc(jnp.asarray(p), jnp.asarray(y), num_classes=C, max_fpr=0.5))
    _raises_same(lambda: ptf.roc(torch.from_numpy(p), torch.from_numpy(y), num_classes=C + 1),
                 lambda: mtf.roc(jnp.asarray(p), jnp.asarray(y), num_classes=C + 1))
    _raises_same(lambda: ptf.auc(torch.tensor([0.0, 2.0, 1.0]), torch.tensor([1.0, 1.0, 1.0])),
                 lambda: mtf.auc(jnp.asarray([0.0, 2.0, 1.0]), jnp.asarray([1.0, 1.0, 1.0])))
    _raises_same(lambda: ptf.auc(torch.zeros(2, 2), torch.zeros(4)), lambda: mtf.auc(jnp.zeros((2, 2)), jnp.zeros(4)))
    _raises_same(lambda: ptf.auc(torch.zeros(3), torch.zeros(4)), lambda: mtf.auc(jnp.zeros(3), jnp.zeros(4)))


def test_mode_change_message_matches_jax():
    ref, port = mt.AUROC(), pt.AUROC(device="cpu")
    p, y = _data("binary", 15)
    pm, ym = _data("multiclass", 15)
    ref.update(jnp.asarray(p), jnp.asarray(y))
    port.update(torch.from_numpy(p), torch.from_numpy(y))
    _raises_same(lambda: port.update(torch.from_numpy(pm), torch.from_numpy(ym)),
                 lambda: ref.update(jnp.asarray(pm), jnp.asarray(ym)))


@pytest.mark.parametrize("name", ["AUROC", "AveragePrecision", "ROC", "PrecisionRecallCurve"])
def test_sketch_modes_raise_not_implemented(name):
    # the sketch modes are ported: they build the JAX package's histogram state
    # (tests/test_torch_sketch.py holds their values); an unknown mode still raises
    port, ref = getattr(pt, name)(approx="sketch", device="cpu"), getattr(mt, name)(approx="sketch")
    assert tuple(port.hist.counts.shape) == tuple(ref.hist.counts.shape) == (2, 2048)
    assert port.hist.counts.dtype == torch.int64
    with pytest.raises(ValueError):
        getattr(pt, name)(approx="bogus", device="cpu")


# --------------------------------------------------- copies and checkpoints
@pytest.mark.parametrize("capacity", [None, 256])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_state_dict_carried_across_packages(capacity, direction):
    batches = [_data("binary", 60 + i, n=32) for i in range(4)]
    full = mt.AUROC(pos_label=1, capacity=capacity)
    for p, y in batches:
        full.update(jnp.asarray(p), jnp.asarray(y))
    ref, port = mt.AUROC(pos_label=1, capacity=capacity), pt.AUROC(pos_label=1, capacity=capacity, device="cpu")
    ref.persistent(True)
    port.persistent(True)
    first, second = (ref, port) if direction == "jax_to_port" else (port, ref)
    conv = {id(ref): jnp.asarray, id(port): torch.from_numpy}
    for p, y in batches[:2]:
        first.update(conv[id(first)](p), conv[id(first)](y))
    saved = first.state_dict()
    if capacity is not None:
        assert set(saved["preds"]) == {"data", "count"} and int(saved["preds"]["count"]) == 64
    else:
        assert isinstance(saved["preds"], list) and len(saved["preds"]) == 2
    second.load_state_dict(saved)
    second.mode = first.mode
    for p, y in batches[2:]:
        second.update(conv[id(second)](p), conv[id(second)](y))
    np.testing.assert_allclose(float(second.compute()), float(full.compute()), rtol=RTOL_SCORE)


@pytest.mark.parametrize("capacity", [None, 256])
@pytest.mark.parametrize("copy", ["pickle", "clone"])
def test_pickle_and_clone_keep_updating(capacity, copy):
    batches = [_data("binary", 70 + i, n=32) for i in range(3)]
    m = pt.AUROC(pos_label=1, capacity=capacity, device="cpu")
    m.update(*(torch.from_numpy(x) for x in batches[0]))
    c = pickle.loads(pickle.dumps(m)) if copy == "pickle" else m.clone()
    for metric in (m, c):
        for p, y in batches[1:]:
            metric(torch.from_numpy(p), torch.from_numpy(y))
    assert torch.equal(m.compute(), c.compute())
    ref = mt.AUROC(pos_label=1)
    for p, y in batches:
        ref.update(jnp.asarray(p), jnp.asarray(y))
    np.testing.assert_allclose(float(c.compute()), float(ref.compute()), rtol=RTOL_SCORE)
