"""The pure view, the keyed slab and the wrappers of the port against the JAX package.

The same numpy inputs (from a seed) go through ``metrics_tpu`` and
``metrics_tpu_torch`` (``device="cpu"``), at small sizes (K = 64 slots, 16
sketch bins, batches of a few hundred):

* the pure view (``init -> update -> merge -> compute``) of a sum, a cat and a
  sketch metric equals the stateful metric and the JAX package's pure view,
  and leaves the metric's own state as it was;
* every slab function (scatter with out-of-range ids, min / max fills,
  ``slab_take_rows``, the touched mask, the drop count, merges, the spec
  checks) equals the JAX package's;
* ``Keyed`` over Accuracy, MeanSquaredError, ``AUROC(approx="sketch")`` and
  Quantile, with integer slots (out-of-range ids dropped) and with ``lru=True``
  string keys (evictions, ``evicted_mass_dropped``), state for state and value
  for value; ``mergeable_partial`` read by the other package both ways, and
  ``state_dict`` loaded across the packages;
* ``HeavyHitters``: the same promotions and demotions as the JAX package, every
  state equal, and hot + tail mass conserved;
* ``BootStrapper``: the stacked and the loop mode equal copy for copy, both
  equal to the JAX package on the same seed;
* ``Running`` (with a checkpoint round trip), ``MetricTracker``,
  ``ClasswiseWrapper``, ``MinMaxMetric`` and ``MultioutputWrapper``;
* the counters' slab keys equal the JAX package's after the same stream;
* the per-sample deltas run under ``torch.func.vmap`` with no per-sample
  fallback loop.

Tolerances: integers (counts, rows, slots) are exact. Float states and values
agree to rtol 1e-6 (float32 sums of a few hundred terms in another order);
the sketch curve values to rtol 1e-5, as in ``test_torch_sketch.py`` (the port
computes them in float64 from int64 counts, the JAX package in float32).
"""
import copy
import pickle
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt
import metrics_tpu.observability.counters as jcounters
import metrics_tpu.parallel.qsketch as jqs
import metrics_tpu.parallel.sketch as jsk
import metrics_tpu.parallel.slab as jslab
import metrics_tpu_torch as pt
import metrics_tpu_torch.observability.counters as pcounters
from metrics_tpu_torch.core.metric import Metric, _fingerprint_value
from metrics_tpu_torch.parallel import slab as pslab

torch.set_num_threads(1)

K, BINS, CLASSES = 64, 16, 5
RTOL, RTOL_SKETCH = 1e-6, 1e-5
CPU = {"device": "cpu"}


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _counts(value):
    return _np(value.counts) if hasattr(value, "counts") else _np(value)


def _batch(seed, n, num_slots=K, drops=True):
    """One batch of every input kind, from a seed; slot ids uniform over
    ``[0, K)`` with a few ``-1`` and ``K`` ids when ``drops``."""
    rng = np.random.RandomState(seed)
    labels = (rng.rand(n) < 0.4).astype(np.int64)
    scores = (1 / (1 + np.exp(-(rng.randn(n) + labels)))).astype(np.float32)
    logits = rng.randn(n, CLASSES).astype(np.float32)
    probs = (np.exp(logits) / np.exp(logits).sum(1, keepdims=True)).astype(np.float32)
    classes = rng.randint(0, CLASSES, n).astype(np.int64)
    target = np.exp(rng.randn(n)).astype(np.float32)
    preds = (target * np.exp(0.2 * rng.randn(n))).astype(np.float32)
    latency = (0.02 * np.exp(rng.randn(n))).astype(np.float32)
    slots = rng.randint(0, num_slots, n).astype(np.int64)
    if drops:
        slots[:3] = -1
        slots[3:5] = num_slots
    return {"scores": scores, "labels": labels, "probs": probs, "classes": classes, "preds": preds,
            "target": target, "latency": latency, "slots": slots}


# inner metric of each case: (JAX ctor, port ctor, the batch's argument names, value tolerance)
_INNER = {
    "accuracy": (lambda: mt.Accuracy(), lambda: pt.Accuracy(**CPU), ("probs", "classes"), RTOL),
    "mse": (lambda: mt.MeanSquaredError(), lambda: pt.MeanSquaredError(**CPU), ("preds", "target"), RTOL),
    "auroc_sketch": (lambda: mt.AUROC(approx="sketch", num_bins=BINS),
                     lambda: pt.AUROC(approx="sketch", num_bins=BINS, **CPU), ("scores", "labels"), RTOL_SKETCH),
    "quantile": (lambda: mt.Quantile(q=(0.5, 0.99)), lambda: pt.Quantile(q=(0.5, 0.99), **CPU), ("latency",), RTOL),
}


def _args(batch, names, jax=False):
    return tuple(jnp.asarray(batch[n]) if jax else torch.from_numpy(batch[n]) for n in names)


def _assert_states_equal(port_metric, jax_metric, rtol=RTOL):
    assert sorted(port_metric._defaults) == sorted(jax_metric._defaults)
    for name in port_metric._defaults:
        got, want = _counts(getattr(port_metric, name)), _counts(getattr(jax_metric, name))
        assert got.shape == want.shape, name
        if np.issubdtype(got.dtype, np.integer):
            assert np.array_equal(got, want), name
        else:
            np.testing.assert_allclose(got, want, rtol=rtol, err_msg=name)


def _assert_values_equal(got, want, rtol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    assert np.array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=rtol, atol=0.0, equal_nan=True)


# ------------------------------------------------------------------ pure view
@pytest.mark.parametrize("kind", ["sum", "cat", "sketch"])
def test_pure_view_equals_the_stateful_metric_and_jax(kind):
    make = {
        "sum": (lambda: pt.MeanSquaredError(**CPU), lambda: mt.MeanSquaredError(), ("preds", "target")),
        "cat": (lambda: pt.AUROC(**CPU), lambda: mt.AUROC(), ("scores", "labels")),
        "sketch": (lambda: pt.AUROC(approx="sketch", num_bins=BINS, **CPU),
                   lambda: mt.AUROC(approx="sketch", num_bins=BINS), ("scores", "labels")),
    }[kind]
    metric, jmetric = make[0](), make[1]()
    pure, jpure = metric.pure(), jmetric.pure()
    assert isinstance(pure, pt.PureMetric) and pure._fields == jpure._fields
    stateful = make[0]()
    batches = [_batch(s, n) for s, n in ((1, 120), (2, 75), (3, 200))]
    state, jstate = pure.init(), jpure.init()
    deltas = []
    for b in batches:
        delta = pure.update(pure.init(), *_args(b, make[2]))
        deltas.append(delta)
        state = pure.update(state, *_args(b, make[2]))
        jstate = jpure.update(jstate, *_args(b, make[2], jax=True))
        stateful.update(*_args(b, make[2]))
    merged = pure.init()
    for delta in deltas:
        merged = pure.merge(merged, delta)
    for value in (pure.compute(state), pure.compute(merged)):
        assert float(value) == float(stateful.compute())
        np.testing.assert_allclose(float(value), float(jpure.compute(jstate)), rtol=RTOL_SKETCH)
    # the metric's own state is still its default
    for name, value in metric._current_state().items():
        fresh = metric.init_state()[name]
        assert (value == fresh if isinstance(value, list) else np.array_equal(_counts(value), _counts(fresh))), name


# ------------------------------------------------------------------ the slab
@pytest.mark.parametrize("reduce", ["sum", "mean", "min", "max"])
@pytest.mark.parametrize("dtype", ["float32", "int64"])
def test_slab_scatter_drops_out_of_range_ids_as_jax(reduce, dtype):
    rng = np.random.RandomState(4)
    deltas = (rng.randn(300, 3) * 10).astype(dtype)
    ids = rng.randint(-2, 12, 300)
    got = pslab.slab_scatter(reduce, torch.from_numpy(deltas), torch.from_numpy(ids), 10)
    want = np.asarray(jslab.slab_scatter(reduce, jnp.asarray(deltas.astype(np.float32 if dtype == "float32" else
                                                                           np.int32)),
                                          jnp.asarray(ids.astype(np.int32)), 10))
    if dtype == "int64" and reduce in ("min", "max"):  # empty rows: the identity of each side's int dtype
        empty = np.bincount(ids[(ids >= 0) & (ids < 10)], minlength=10) == 0
        info = np.iinfo(np.int64)
        assert np.array_equal(_np(got)[empty], np.full((empty.sum(), 3), info.max if reduce == "min" else info.min))
        assert np.array_equal(_np(got)[~empty], want[~empty])
    else:
        assert np.array_equal(_np(got), want)
    assert pslab.slab_sync_reduce(reduce) == jslab.slab_sync_reduce(reduce)


def test_slab_helpers_equal_jax():
    rng = np.random.RandomState(5)
    ids = rng.randint(-1, 9, 50)
    assert np.array_equal(_np(pslab.slab_touched_mask(torch.from_numpy(ids), 8)),
                          np.asarray(jslab.slab_touched_mask(jnp.asarray(ids.astype(np.int32)), 8)))
    assert pslab.dropped_slot_count(torch.from_numpy(ids), 8) == jslab.dropped_slot_count(ids, 8) > 0
    assert pslab.dropped_slot_count(ids, 8) == jslab.dropped_slot_count(ids, 8)
    slab = rng.randn(8, 2, 3).astype(np.float32)
    assert np.array_equal(_np(pslab.slab_take_rows(torch.from_numpy(slab), [5, 1, 5])),
                          np.asarray(jslab.slab_take_rows(jnp.asarray(slab), [5, 1, 5])))
    counts = rng.randint(0, 9, (8, 2, 4))
    sketch = pt.parallel.HistogramSketch(torch.from_numpy(counts))
    assert np.array_equal(_np(pslab.slab_take_rows(sketch, [7, 0])),
                          np.asarray(jslab.slab_take_rows(jsk.HistogramSketch(jnp.asarray(counts)), [7, 0])))
    a, b = rng.randn(8, 3).astype(np.float32), rng.randn(8, 3).astype(np.float32)
    for reduce in pslab.SLAB_REDUCES:
        assert np.array_equal(_np(pslab.slab_merge(reduce, torch.from_numpy(a), torch.from_numpy(b))),
                              np.asarray(jslab.slab_merge(reduce, jnp.asarray(a), jnp.asarray(b))))
    assert pslab.PARTIAL_SCHEMA_VERSION == jslab.PARTIAL_SCHEMA_VERSION == 1


def test_slab_specs_fills_and_rejections_equal_jax():
    template = np.asarray([np.inf, 2.5, -1.0], dtype=np.float32)
    spec, jspec = pslab.make_slab_spec(4, template, "min"), jslab.make_slab_spec(4, template, "min")
    assert spec.fill == jspec.fill and spec.item_shape == jspec.item_shape and spec.row_shape == jspec.row_shape
    assert np.array_equal(_np(pslab.slab_init(spec)), np.asarray(jslab.slab_init(jspec)))
    assert np.array_equal(spec.fill_template(), jspec.fill_template())
    assert pslab.make_slab_spec(4, np.zeros(3, np.float32), "sum").fill is None
    hist = pslab.make_slab_spec(6, np.zeros((2, 4), np.int64), "sum", kind="hist")
    assert type(pslab.slab_init(hist)).__name__ == "HistogramSketch" and pslab.slab_init(hist).counts.shape == (6, 2, 4)
    assert pslab.slab_rows_spec(6).dtype == torch.int64
    for args in ((4, np.ones(3, np.float32), "sum"), (4, np.zeros(3), "median"), (0, np.zeros(3), "sum"),
                 (4, np.zeros(3), "sum", "table")):
        with pytest.raises(ValueError):
            pslab.make_slab_spec(*args)
        with pytest.raises(ValueError):
            jslab.make_slab_spec(*args)
    with pytest.raises(ValueError, match="version"):
        pslab.check_partial_version({"version": 2, "rows": None, "state": {}})
    with pytest.raises(ValueError, match="not a mergeable partial"):
        pslab.check_partial_version({"rows": None})


def test_lru_slot_table_equals_jax():
    table, jtable = pslab.LRUSlotTable(3), jslab.LRUSlotTable(3)
    for keys in (["a", "b", "a"], ["c", "d"], ["b", "e", "a"], ["f"]):
        got, want = table.resolve(keys), jtable.resolve(keys)
        assert np.array_equal(got[0], want[0]) and got[1] == want[1]
    assert table.keys() == jtable.keys() and table.evictions == jtable.evictions == 5
    with pytest.raises(ValueError, match="more than num_slots"):
        table.resolve(["x", "y", "z", "w"])
    restored = pslab.LRUSlotTable(3)
    restored.load_state(jtable.state())
    assert restored.keys() == jtable.keys() and restored.slot_of("f") == jtable.slot_of("f")


class _Extremes(Metric):
    """A toy metric with min and max states and a nonzero min default."""

    _GROUP_UPDATE_ATTRS = ()

    def __init__(self, slots=None, **kw):
        super().__init__(**kw)
        self.add_state("low", default=torch.tensor(3.0), dist_reduce_fx="min")
        self.add_state("high", default=torch.tensor(float("-inf")), dist_reduce_fx="max")
        if slots is not None:
            self.add_state("rows", default=pslab.make_slab_spec(slots, np.zeros(2, np.float32), "sum"),
                           dist_reduce_fx="sum")

    def update(self, values):
        self.low = torch.minimum(self.low, values.min())
        self.high = torch.maximum(self.high, values.max())

    def compute(self):
        return torch.stack([self.low, self.high])


def test_keyed_min_max_states_keep_their_fill_and_identity():
    values = torch.tensor([5.0, 1.0, 7.0, 2.0, 9.0])
    keyed = pt.Keyed(_Extremes(**CPU), num_slots=4)
    keyed.update(values, slot=torch.tensor([0, 0, 1, 3, -1]))
    assert _np(keyed.compute()).tolist()[:2] == [[1.0, 5.0], [3.0, 7.0]]
    assert np.isnan(_np(keyed.compute(slot=2))).all() and _np(keyed.compute(slot=3)).tolist() == [2.0, 2.0]
    with pytest.raises(ValueError, match="slab state syncs"):
        keyed.add_state("bad", default=pslab.make_slab_spec(4, np.zeros(1, np.float32), "min"), dist_reduce_fx="sum")
    # slab specs are compute-group key material: equal specs group, other slot counts split
    assert _fingerprint_value(pslab.make_slab_spec(4, np.zeros(2), "sum")) == \
        _fingerprint_value(pslab.make_slab_spec(4, np.zeros(2), "sum"))
    col = pt.MetricCollection({"a": _Extremes(slots=4, **CPU), "b": _Extremes(slots=4, **CPU),
                               "c": _Extremes(slots=5, **CPU)})
    col.update(values)
    assert sorted(map(sorted, col.compute_groups.values())) == [["a", "b"], ["c"]]


# --------------------------------------------------------------------- Keyed
@pytest.mark.parametrize("inner", sorted(_INNER))
def test_keyed_equals_jax_state_for_state(inner):
    jctor, pctor, names, rtol = _INNER[inner]
    keyed, jkeyed = pt.Keyed(pctor(), num_slots=K), mt.Keyed(jctor(), num_slots=K)
    for seed, n in ((10, 300), (11, 180), (12, 257)):
        b = _batch(seed, n)
        keyed.update(*_args(b, names), slot=torch.from_numpy(b["slots"]))
        jkeyed.update(*_args(b, names, jax=True), slot=jnp.asarray(b["slots"].astype(np.int32)))
    _assert_states_equal(keyed, jkeyed)
    assert _np(keyed.keyed_rows).sum() == sum(n - 5 for n in (300, 180, 257))
    _assert_values_equal(keyed.compute(), jkeyed.compute(), rtol)
    _assert_values_equal(keyed.compute(slot=7), jkeyed.compute(slot=7), rtol)
    # the fused forward: the batch value over K slots, and the accumulator
    b = _batch(13, 140)
    _assert_values_equal(keyed(*_args(b, names), slot=torch.from_numpy(b["slots"])),
                         jkeyed(*_args(b, names, jax=True), slot=jnp.asarray(b["slots"].astype(np.int32))), rtol)
    _assert_states_equal(keyed, jkeyed)
    # equal to K independent metrics, each fed its own segment's samples
    ref = pctor()
    sel = b["slots"] == 3
    ref.update(*(torch.from_numpy(b[n][sel]) for n in names))
    _assert_values_equal(pt.Keyed(pctor(), num_slots=K).forward(*_args(b, names), slot=b["slots"])[3],
                         ref.compute(), rtol)


@pytest.mark.parametrize("empty", ["nan", "zero"])
def test_keyed_empty_policy_and_slot_ids_as_host_arrays(empty):
    b = _batch(20, 90, num_slots=8)
    keyed = pt.Keyed(pt.Accuracy(**CPU), num_slots=8, empty=empty)
    jkeyed = mt.Keyed(mt.Accuracy(), num_slots=8, empty=empty)
    keyed.update(*_args(b, ("probs", "classes")), slot=b["slots"].tolist())
    keyed.update(*_args(b, ("probs", "classes")), slot=np.full(90, 7))
    jkeyed.update(*_args(b, ("probs", "classes"), jax=True), slot=jnp.asarray(b["slots"].astype(np.int32)))
    jkeyed.update(*_args(b, ("probs", "classes"), jax=True), slot=jnp.full(90, 7, jnp.int32))
    _assert_values_equal(keyed.compute(), jkeyed.compute(), RTOL)
    with pytest.raises(ValueError, match="slot="):
        keyed.update(*_args(b, ("probs", "classes")))
    with pytest.raises(ValueError, match="cat/list/buffer"):
        pt.Keyed(pt.AUROC(**CPU), num_slots=4)
    with pytest.raises(ValueError, match="empty"):
        pt.Keyed(pt.Accuracy(**CPU), num_slots=4, empty="drop")


def test_keyed_lru_string_keys_evict_as_jax():
    keyed = pt.Keyed(pt.MeanSquaredError(**CPU), num_slots=4, lru=True)
    jkeyed = mt.Keyed(mt.MeanSquaredError(), num_slots=4, lru=True)
    pcounters.reset()
    jcounters.reset()
    rng = np.random.RandomState(21)
    for step in range(6):
        keys = [f"tenant-{k}" for k in rng.choice(np.arange(step, step + 5), 3)]
        keys = [keys[i % 3] for i in range(30)]
        b = _batch(30 + step, 30)
        keyed.update(*_args(b, ("preds", "target")), slot=keys)
        jkeyed.update(*_args(b, ("preds", "target"), jax=True), slot=keys)
        assert keyed._slots.keys() == jkeyed._slots.keys()
    _assert_states_equal(keyed, jkeyed)
    assert keyed._slots.evictions == jkeyed._slots.evictions > 0
    assert pcounters.snapshot()["evicted_mass_dropped"] == jcounters.snapshot()["evicted_mass_dropped"] > 0
    key = keyed._slots.keys()[-1]
    _assert_values_equal(keyed.compute(slot=key), jkeyed.compute(slot=key), RTOL)
    with pytest.raises(KeyError):
        keyed.compute(slot="tenant-never")
    with pytest.raises(ValueError, match="not mergeable"):
        keyed.mergeable_partial()
    # the key table rides state_dict, across the packages and back
    restored = pt.Keyed(pt.MeanSquaredError(**CPU), num_slots=4, lru=True)
    restored.load_state_dict(jkeyed.state_dict())
    assert restored._slots.keys() == jkeyed._slots.keys()
    _assert_values_equal(restored.compute(), jkeyed.compute(), RTOL)
    back = mt.Keyed(mt.MeanSquaredError(), num_slots=4, lru=True)
    back.load_state_dict(keyed.state_dict())
    _assert_values_equal(keyed.compute(), back.compute(), RTOL)


def _to_jax_partial(partial):
    """The port's partial in the JAX package's types: sketch leaves map by class name."""
    kinds = {"HistogramSketch": jsk.HistogramSketch, "RankSketch": jsk.RankSketch,
             "QuantileSketch": jqs.QuantileSketch}
    state = {k: kinds[type(v).__name__](np.asarray(v.counts)) if hasattr(v, "counts") else v
             for k, v in partial["state"].items()}
    return {**partial, "state": state}


@pytest.mark.parametrize("inner", ["mse", "auroc_sketch"])
def test_mergeable_partials_cross_the_packages_both_ways(inner):
    jctor, pctor, names, rtol = _INNER[inner]
    shards = [_batch(40 + i, n) for i, n in enumerate((150, 90, 200))]
    port_parts, jax_parts = [], []
    one, jone = pt.Keyed(pctor(), num_slots=K), mt.Keyed(jctor(), num_slots=K)
    for b in shards:
        shard, jshard = pt.Keyed(pctor(), num_slots=K), mt.Keyed(jctor(), num_slots=K)
        shard.update(*_args(b, names), slot=torch.from_numpy(b["slots"]))
        jshard.update(*_args(b, names, jax=True), slot=jnp.asarray(b["slots"].astype(np.int32)))
        one.update(*_args(b, names), slot=torch.from_numpy(b["slots"]))
        jone.update(*_args(b, names, jax=True), slot=jnp.asarray(b["slots"].astype(np.int32)))
        port_parts.append(shard.mergeable_partial())
        jax_parts.append(jshard.mergeable_partial())
    assert all(p["version"] == 1 and isinstance(p["rows"], np.ndarray) for p in port_parts)
    want = one.compute()
    # a port partial into the JAX package, a JAX partial into the port, and mixed
    _assert_values_equal(pt.Keyed(pctor(), num_slots=K).value_from_partials(port_parts), want, RTOL)
    _assert_values_equal(jone.value_from_partials([_to_jax_partial(p) for p in port_parts]), want, rtol)
    _assert_values_equal(pt.Keyed(pctor(), num_slots=K).value_from_partials(jax_parts), want, RTOL)
    _assert_values_equal(pt.Keyed(pctor(), num_slots=K).value_from_partials(jax_parts[:1] + port_parts[1:]), want, RTOL)
    empty = pt.Keyed(pctor(), num_slots=K).value_from_partials([])
    assert np.isnan(_np(empty)).all()
    with pytest.raises(ValueError, match="version"):
        one.value_from_partials([{**port_parts[0], "version": 0}])


@pytest.mark.parametrize("inner", ["accuracy", "auroc_sketch", "quantile"])
def test_keyed_state_dict_loads_across_the_packages(inner):
    jctor, pctor, names, rtol = _INNER[inner]
    b = _batch(50, 240)
    keyed, jkeyed = pt.Keyed(pctor(), num_slots=K), mt.Keyed(jctor(), num_slots=K)
    keyed.update(*_args(b, names), slot=torch.from_numpy(b["slots"]))
    jkeyed.update(*_args(b, names, jax=True), slot=jnp.asarray(b["slots"].astype(np.int32)))
    keyed.persistent(True)
    jkeyed.persistent(True)
    assert sorted(keyed.state_dict()) == sorted(jkeyed.state_dict())
    into_port = pt.Keyed(pctor(), num_slots=K)
    into_port.load_state_dict(jkeyed.state_dict())
    into_jax = mt.Keyed(jctor(), num_slots=K)
    into_jax.load_state_dict(keyed.state_dict())
    _assert_states_equal(into_port, jkeyed)
    _assert_states_equal(keyed, into_jax)
    assert into_port.hist.counts.dtype == torch.int64 if inner == "auroc_sketch" else True
    _assert_values_equal(into_port.compute(), keyed.compute(), 0.0)
    # pickle and deepcopy keep the slab and the wrapped compute
    for clone in (pickle.loads(pickle.dumps(keyed)), copy.deepcopy(keyed)):
        _assert_values_equal(clone.compute(slot=5), keyed.compute(slot=5), 0.0)


def test_keyed_vmapped_deltas_take_no_per_sample_fallback():
    b = _batch(60, 64)
    for _, pctor, names, _ in _INNER.values():
        keyed = pt.Keyed(pctor(), num_slots=K)
        with warnings.catch_warnings():
            warnings.filterwarnings("error", message=".*performance drop.*")
            keyed.update(*_args(b, names), slot=torch.from_numpy(b["slots"]))
            keyed.compute()


def test_keyed_chunks_equal_one_chunk(monkeypatch):
    import metrics_tpu_torch.wrappers.keyed as keyed_mod

    b = _batch(61, 300)
    whole = pt.Keyed(pt.AUROC(approx="sketch", num_bins=BINS, **CPU), num_slots=K)
    whole.update(*_args(b, ("scores", "labels")), slot=torch.from_numpy(b["slots"]))
    monkeypatch.setattr(keyed_mod, "DELTA_CHUNK_BYTES", 7 * 2 * (2 * BINS * 8 + 16))  # 7 samples a chunk
    monkeypatch.setattr(keyed_mod, "FINISH_CHUNK_BYTES", 5 * 2 * BINS * 8)  # 5 slots a finisher call
    chunked = pt.Keyed(pt.AUROC(approx="sketch", num_bins=BINS, **CPU), num_slots=K)
    chunked.update(*_args(b, ("scores", "labels")), slot=torch.from_numpy(b["slots"]))
    assert torch.equal(whole.hist.counts, chunked.hist.counts)
    _assert_values_equal(chunked.compute(), whole.compute(), 0.0)


# -------------------------------------------------------------- HeavyHitters
def _zipf_keys(seed, n, space):
    rng = np.random.RandomState(seed)
    return ((rng.zipf(1.3, n) - 1) % space).tolist()


@pytest.mark.parametrize("inner", ["accuracy", "auroc_sketch"])
def test_heavy_hitters_equal_jax_and_conserve_mass(inner):
    jctor, pctor, names, rtol = _INNER[inner]
    hh = pt.HeavyHitters(pctor(), num_hot_slots=4, tail=(4, 32))
    jhh = mt.HeavyHitters(jctor(), num_hot_slots=4, tail=(4, 32))
    total, hist = 0, np.zeros((2, BINS), np.int64)
    for step in range(6):
        b = _batch(70 + step, 150, drops=False)
        keys = _zipf_keys(80 + step, 150, 40 + 10 * step)  # the key space widens: keys promote and demote
        hh.update(*_args(b, names), key=keys)
        jhh.update(*_args(b, names, jax=True), key=keys)
        total += 150
        if inner == "auroc_sketch":
            bins = np.clip(np.floor(b["scores"] * np.float32(BINS)), 0, BINS - 1).astype(np.int64)
            np.add.at(hist, (1 - b["labels"], bins), 1)
    table, jtable = hh._table.state(), jhh._table.state()
    assert table["keys"] == jtable["keys"]
    for field in ("slots", "hot", "credit", "residue", "mirror", "promotions", "demotions"):
        assert np.array_equal(table[field], jtable[field]), field
    assert hh._table.demotions > 0 and hh._table.promotions > 4
    _assert_states_equal(hh, jhh)
    # conservation: hot rows + tail mass = every sample; the same for the counts
    assert int(hh.hh_rows.sum()) + hh.tail_mass() == total
    if inner == "auroc_sketch":
        assert np.array_equal(_np(hh.hist.counts.sum(0)) + _np(hh.hist_tail.counts[0].sum(0)), hist)
    _assert_values_equal(hh.compute(), jhh.compute(), rtol)
    for got, want in zip(hh.compute_heavy_hitters(), jhh.compute_heavy_hitters()):
        assert (got["key"], got["slot"], got["count"], got["samples"], got["exact"]) == \
            (want["key"], want["slot"], want["count"], want["samples"], want["exact"])
    cold = next(k for k in range(60) if k not in hh._table)
    est, jest = hh.tail_estimate(cold), jhh.tail_estimate(cold)
    assert (est["count"], est["exact"]) == (jest["count"], jest["exact"])
    np.testing.assert_allclose(est["bound"], jest["bound"], rtol=RTOL)
    assert hh.tail_overcount_bound() == pytest.approx(jhh.tail_overcount_bound(), rel=RTOL)
    # the table rides state_dict
    restored = pt.HeavyHitters(pctor(), num_hot_slots=4, tail=(4, 32))
    restored.load_state_dict(jhh.state_dict())
    assert restored._table.keys() == jhh._table.keys()
    _assert_values_equal(restored.compute(), hh.compute(), 0.0)


def test_heavy_hitters_rejects_min_max_and_cat_states():
    with pytest.raises(ValueError, match="'sum'/'mean'"):
        pt.HeavyHitters(_Extremes(**CPU), num_hot_slots=2)
    with pytest.raises(ValueError, match="cat/list/buffer"):
        pt.HeavyHitters(pt.AUROC(**CPU), num_hot_slots=2)
    with pytest.raises(ValueError, match="key="):
        pt.HeavyHitters(pt.Accuracy(**CPU), num_hot_slots=2).update(torch.zeros(3), torch.zeros(3, dtype=torch.int64))


# -------------------------------------------------------------- BootStrapper
@pytest.mark.parametrize("inner", ["mse", "auroc_sketch", "accuracy"])
def test_bootstrapper_stacked_and_loop_equal_copy_for_copy_and_jax(inner):
    jctor, pctor, names, rtol = _INNER[inner]
    stacked = pt.BootStrapper(pctor(), num_bootstraps=6, seed=3, raw=True)
    loop = pt.BootStrapper(pctor(), num_bootstraps=6, seed=3, raw=True, dist_sync_fn=lambda t: [t])
    jboot = mt.BootStrapper(jctor(), num_bootstraps=6, seed=3, raw=True)
    for seed, n in ((90, 120), (91, 77)):
        b = _batch(seed, n)
        got_s, got_l = stacked(*_args(b, names)), loop(*_args(b, names))
        want = jboot(*_args(b, names, jax=True))
        for key in ("mean", "std", "raw"):
            np.testing.assert_allclose(_np(got_s[key]), _np(got_l[key]), rtol=RTOL)
            np.testing.assert_allclose(_np(got_s[key]), np.asarray(want[key]), rtol=rtol)
    assert stacked._mode == "stacked" and loop._mode == "loop"
    for k, child in enumerate(loop.metrics):
        for name, value in child._current_state().items():
            got, want = _counts(stacked._stacked[name])[k], _counts(value)
            np.testing.assert_allclose(got, want, rtol=RTOL)
            np.testing.assert_allclose(got, _counts(jboot._stacked[name])[k], rtol=RTOL)
    for out in (stacked.compute(), loop.compute()):
        for key in ("mean", "std", "raw"):
            np.testing.assert_allclose(_np(out[key]), np.asarray(jboot.compute()[key]), rtol=rtol)
    stacked.reset()
    assert stacked._stacked is None


# ----------------------------------------------------------- other wrappers
def test_running_window_equals_jax_and_round_trips_its_checkpoint():
    running, jrunning = pt.Running(pt.MeanSquaredError(**CPU), window=3), mt.Running(mt.MeanSquaredError(), window=3)
    for seed in range(5):
        b = _batch(100 + seed, 50)
        np.testing.assert_allclose(float(running(*_args(b, ("preds", "target")))),
                                   float(jrunning(*_args(b, ("preds", "target"), jax=True))), rtol=RTOL)
    assert len(running._deltas) == 3
    restored = pt.Running(pt.MeanSquaredError(**CPU), window=3)
    restored.load_state_dict(running.state_dict())
    assert float(restored.compute()) == float(running.compute())
    from_jax = pt.Running(pt.MeanSquaredError(**CPU), window=3)
    from_jax.load_state_dict(jrunning.state_dict())
    np.testing.assert_allclose(float(from_jax.compute()), float(jrunning.compute()), rtol=RTOL)
    sketch = pt.Running(pt.AUROC(approx="sketch", num_bins=BINS, **CPU), window=2)
    sketch.update(*_args(_batch(110, 80), ("scores", "labels")))
    again = pt.Running(pt.AUROC(approx="sketch", num_bins=BINS, **CPU), window=2)
    again.load_state_dict(sketch.state_dict())
    assert float(again.compute()) == float(sketch.compute())


def test_metric_tracker_equals_jax():
    tracker, jtracker = pt.MetricTracker(pt.Accuracy(**CPU)), mt.MetricTracker(mt.Accuracy())
    with pytest.raises(RuntimeError, match="increment"):
        tracker.update(*_args(_batch(120, 10), ("probs", "classes")))
    for epoch in range(3):
        tracker.increment()
        jtracker.increment()
        for seed in range(2):
            b = _batch(121 + 10 * epoch + seed, 60)
            tracker(*_args(b, ("probs", "classes")))
            jtracker(*_args(b, ("probs", "classes"), jax=True))
    np.testing.assert_allclose(_np(tracker.compute_all()), np.asarray(jtracker.compute_all()), rtol=RTOL)
    best, step = tracker.best_metric(return_step=True)
    jbest, jstep = jtracker.best_metric(return_step=True)
    assert step == jstep and float(best) == pytest.approx(float(jbest), rel=RTOL) and tracker.n_steps == 3


def test_classwise_minmax_and_multioutput_equal_jax():
    b = _batch(130, 90)
    classwise = pt.ClasswiseWrapper(pt.Precision(num_classes=CLASSES, average=None, **CPU), labels=list("abcde"))
    jclasswise = mt.ClasswiseWrapper(mt.Precision(num_classes=CLASSES, average=None), labels=list("abcde"))
    got, want = classwise(*_args(b, ("probs", "classes"))), jclasswise(*_args(b, ("probs", "classes"), jax=True))
    assert sorted(got) == sorted(want)
    for key in got:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=RTOL)

    minmax, jminmax = pt.MinMaxMetric(pt.Accuracy(**CPU)), mt.MinMaxMetric(mt.Accuracy())
    for seed in range(4):
        b = _batch(131 + seed, 40 + 20 * seed)
        minmax.update(*_args(b, ("probs", "classes")))
        jminmax.update(*_args(b, ("probs", "classes"), jax=True))
        got, want = minmax.compute(), jminmax.compute()  # each epoch value folds into the extrema
    got, want = minmax.compute(), jminmax.compute()
    for key in ("raw", "min", "max"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=RTOL)
    assert float(minmax.min_val) < float(minmax.max_val)

    rng = np.random.RandomState(132)
    preds = rng.randn(80, 3).astype(np.float32)
    target = (preds + 0.3 * rng.randn(80, 3)).astype(np.float32)
    preds[5, 1] = np.nan
    multi = pt.MultioutputWrapper(pt.R2Score(**CPU), num_outputs=3)
    jmulti = mt.MultioutputWrapper(mt.R2Score(), num_outputs=3)
    np.testing.assert_allclose(_np(multi(torch.from_numpy(preds), torch.from_numpy(target))),
                               np.asarray(jmulti(jnp.asarray(preds), jnp.asarray(target))), rtol=RTOL)
    np.testing.assert_allclose(_np(multi.compute()), np.asarray(jmulti.compute()), rtol=RTOL)
    assert not np.isnan(_np(multi.compute())).any()


def test_minmax_folds_every_batch_value_as_jax():
    minmax, jminmax = pt.MinMaxMetric(pt.Accuracy(**CPU)), mt.MinMaxMetric(mt.Accuracy())
    for seed in range(4):
        b = _batch(140 + seed, 30 + 25 * seed)
        got = minmax(*_args(b, ("probs", "classes")))
        want = jminmax(*_args(b, ("probs", "classes"), jax=True))
        for key in ("raw", "min", "max"):
            np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=RTOL)


# ------------------------------------------------------------------ counters
def test_counters_slab_keys_equal_jax_after_the_same_stream():
    was = jcounters.is_enabled()
    pcounters.reset()
    jcounters.reset()
    pcounters.enable()
    jcounters.enable()
    try:
        keyed, jkeyed = pt.Keyed(pt.Accuracy(**CPU), num_slots=K), mt.Keyed(mt.Accuracy(), num_slots=K)
        lru, jlru = (pt.Keyed(pt.MeanSquaredError(**CPU), num_slots=3, lru=True),
                     mt.Keyed(mt.MeanSquaredError(), num_slots=3, lru=True))
        hh = pt.HeavyHitters(pt.MeanSquaredError(**CPU), num_hot_slots=3, tail=(2, 16))
        jhh = mt.HeavyHitters(mt.MeanSquaredError(), num_hot_slots=3, tail=(2, 16))
        for step in range(4):
            b = _batch(150 + step, 60)
            keyed.update(*_args(b, ("probs", "classes")), slot=torch.from_numpy(b["slots"]))
            jkeyed.update(*_args(b, ("probs", "classes"), jax=True), slot=jnp.asarray(b["slots"].astype(np.int32)))
            keys = [f"k{(step + i) % 5}" for i in range(3)] * 20
            lru.update(*_args(b, ("preds", "target")), slot=keys)
            jlru.update(*_args(b, ("preds", "target"), jax=True), slot=keys)
            hh_keys = _zipf_keys(160 + step, 60, 12)
            hh.update(*_args(b, ("preds", "target")), key=hh_keys)
            jhh.update(*_args(b, ("preds", "target"), jax=True), key=hh_keys)
        got, want = pcounters.snapshot(), jcounters.snapshot()
        for key in ("slab_dropped_samples", "evicted_mass_dropped", "slab_slots", "heavy_hitters"):
            assert got[key] == want[key], key
        assert got["slab_dropped_samples"] == 4 * 5 and got["evicted_mass_dropped"] > 0
        assert set(got) == set(want)  # the JAX package's snapshot schema, key for key
        for key in ("faults", "gather_skips", "deferred", "deferred_depth", "sparse"):
            assert got[key] == want[key], key
        pcounters.disable()
        keyed.update(*_args(b, ("probs", "classes")), slot=torch.from_numpy(b["slots"]))
        assert pcounters.snapshot(reset_after=True)["slab_dropped_samples"] == 5 * 5  # recorded with counting off
        assert pcounters.snapshot() == {"slab_dropped_samples": 0, "evicted_mass_dropped": 0, "slab_slots": {},
                                        "heavy_hitters": {}, "wm_stragglers": 0, "wm_exchange_calls": 0,
                                        "watermark_agreement": {}, "faults": dict.fromkeys(pcounters.FAULT_KINDS, 0),
                                        "gather_skips": 0, "deferred": dict.fromkeys(pcounters.DEFERRED_KINDS, 0),
                                        "deferred_depth": {}, "collective_calls": 0, "sync_bytes": 0,
                                        "calls_by_kind": {}, "bytes_by_kind_dtype": {}, "calls_by_crossing": {},
                                        "bytes_by_crossing": {}, "states_synced": 0,
                                        "sparse": dict.fromkeys(pcounters.SPARSE_KINDS, 0), "state_bytes": {},
                                        "fleet_shards": {}, "service_health": {}, "retention": {}, "lifecycle": {},
                                        "watermark_lag": {}, "publish_staleness": {}, "selfmeter": {},
                                        **{f"{c}_cache": {"hits": 0, "misses": 0} for c in pcounters.CACHES}}
    finally:
        pcounters.disable()
        pcounters.reset()
        jcounters.reset()
        jcounters.enable() if was else jcounters.disable()


def test_wrappers_are_exported_as_in_jax():
    import metrics_tpu_torch.wrappers as pw

    for name in ("PureMetric", "Keyed", "HeavyHitters", "Running", "BootStrapper", "MetricTracker",
                 "ClasswiseWrapper", "MinMaxMetric", "MultioutputWrapper", "Windowed"):
        assert hasattr(mt, name) and name in pt.__all__ and getattr(pt, name) is not None, name
        if name != "PureMetric":
            assert getattr(pt, name) is getattr(pw, name)
    assert pt.core.PureMetric is pt.PureMetric and pt.parallel.SlabSpec is pslab.SlabSpec


def test_routed_forward_resets_the_accumulated_row_where_jax_keeps_its_history():
    """``Keyed(lru=True)`` and ``HeavyHitters`` route each batch against the
    accumulator in ``forward`` too: after an eviction the recycled slot starts
    empty, as after ``update``. The JAX package's fused forward routes against
    the batch delta, so the new key inherits the evicted key's accumulated rows
    (ROADMAP section 3): on this stream it reads 5.0 for key "c" where 9.0 is
    right. The batch values are the JAX package's."""
    stream = [["a"] * 4, ["b"] * 4, ["c"] * 4, ["a"] * 4]

    def run(pkg, forward, **cpu):
        keyed = pkg.Keyed(pkg.MeanSquaredError(**cpu), num_slots=2, lru=True)
        values = []
        for i, keys in enumerate(stream):
            p, t = np.full(4, float(i + 1), np.float32), np.zeros(4, np.float32)
            p, t = (jnp.asarray(p), jnp.asarray(t)) if pkg is mt else (torch.from_numpy(p), torch.from_numpy(t))
            values.append(_np(keyed(p, t, slot=keys)) if forward else keyed.update(p, t, slot=keys))
        return {k: float(keyed.compute(slot=k)) for k in keyed._slots.keys()}, values

    want, _ = run(pt, False, **CPU)
    got, batch_values = run(pt, True, **CPU)
    jax_got, jax_values = run(mt, True)
    assert want == got == {"c": 9.0, "a": 16.0} and jax_got == {"c": 5.0, "a": 10.0}
    for value, jax_value in zip(batch_values, jax_values):
        _assert_values_equal(value, jax_value, RTOL)

    hh_update = pt.HeavyHitters(pt.MeanSquaredError(**CPU), num_hot_slots=3, tail=(4, 16))
    hh_forward = pt.HeavyHitters(pt.MeanSquaredError(**CPU), num_hot_slots=3, tail=(4, 16))
    for step in range(5):
        b = _batch(170 + step, 80)
        keys = _zipf_keys(180 + step, 80, 10 + 8 * step)
        hh_update.update(*_args(b, ("preds", "target")), key=keys)
        assert hh_forward(*_args(b, ("preds", "target")), key=keys).shape == (3,)
    assert hh_update._table.demotions > 0
    for name, state in hh_update._current_state().items():
        np.testing.assert_array_equal(_counts(getattr(hh_forward, name)), _counts(state), err_msg=name)


@pytest.mark.parametrize("inner", ["auroc_sketch", "quantile", "accuracy"])
def test_keyed_update_launches_as_many_operations_for_any_batch(inner):
    """The per-sample deltas are batched by ``torch.func.vmap``: the operations an
    update runs do not grow with the batch (``vmap``'s rule for ``index_add``
    runs one per sample, which is why the sketch scatter is a ``scatter_add``)."""
    from torch.profiler import ProfilerActivity, profile

    _, pctor, names, _ = _INNER[inner]

    def operations(n):
        b = _batch(62, n)
        keyed = pt.Keyed(pctor(), num_slots=K)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            keyed.update(*_args(b, names), slot=torch.from_numpy(b["slots"]))
        return sum(e.count for e in prof.key_averages())

    operations(50)  # the first call makes the grid's device constants once
    assert operations(100) == operations(400)
