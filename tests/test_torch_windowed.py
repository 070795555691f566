"""The windowed plane of the port against the JAX package.

The same numpy inputs (from a seed) go through ``metrics_tpu`` and
``metrics_tpu_torch`` (``device="cpu"``), at small sizes (batches of tens to a
few hundred events, rings of 3-6 windows, 16 sketch bins):

* ``route_events`` on 320 seeded streams (tumbling, sliding, ``agreed=``,
  ``judge_prefix=``, jumps past the ring, the first batch, empty batches):
  every field of ``RouteResult`` bit-equal; ``window_index`` and
  ``decay_scale`` equal; ``WindowSpec.validate`` raises the same errors;
* ``Windowed`` over the ring, sliding windows, the decay accumulator and
  ``Windowed(Keyed(...))``, with Accuracy, MeanSquaredError,
  ``AUROC(approx="sketch")`` and Quantile inners: every state after every
  step, the watermark, head, resident windows, drop and late counts, and every
  value (``compute``, ``compute_window``);
* partials and ``state_dict`` read by the other package both ways, resuming
  mid-window with the same verdicts;
* the watermark agreement (the cases of the JAX package's own tests), the
  exchange in one process, ``TracingUnsupportedError`` under ``vmap``;
* the port's ``forward`` rolls the accumulator (the JAX package's does not:
  ROADMAP section 3) and equals its ``update``.

Tolerances: integer states (counts, rows) and routing are exact. Float states
and values agree to rtol 1e-6 (float32 sums of a few hundred terms in another
order; the decay weights are the same float32 numbers); the sketch curve
values to rtol 1e-5, as in ``test_torch_sketch.py`` (the port computes them
in float64 from int64 counts, the JAX package in float32).
"""
import copy
import math
import pickle
import time
import warnings
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt
import metrics_tpu.core.streaming as jstream
import metrics_tpu.observability.counters as jcounters
import metrics_tpu.parallel.qsketch as jqs
import metrics_tpu.parallel.sketch as jsk
import metrics_tpu_torch as pt
import metrics_tpu_torch.core.streaming as pstream
import metrics_tpu_torch.observability.counters as pcounters
from metrics_tpu_torch.utils.exceptions import SyncTimeoutError, TracingUnsupportedError
from tests.test_torch_sketch import _near_edge

torch.set_num_threads(1)

RTOL, RTOL_SKETCH = 1e-6, 1e-5
CPU = {"device": "cpu"}
BINS = 16


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


def _assert_states(port, ref, rtol=RTOL):
    got, want = port._current_state(), ref._current_state()
    assert set(got) == set(want)
    for name in want:
        g, w = _counts(got[name]), _counts(want[name])
        assert g.shape == w.shape, name
        if np.issubdtype(w.dtype, np.integer) or np.issubdtype(w.dtype, np.bool_):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=rtol, atol=1e-6, err_msg=name)


def _assert_values(got, want, rtol=RTOL):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _assert_values(got[k], want[k], rtol)
        return
    np.testing.assert_allclose(_np(got).astype(np.float64), np.asarray(want, dtype=np.float64), rtol=rtol,
                               atol=1e-7, equal_nan=True)


def _assert_position(port, ref):
    assert port.watermark == ref.watermark
    assert port.head_window == ref.head_window
    assert port.resident_windows() == ref.resident_windows()
    assert port.dropped_samples == ref.dropped_samples
    assert port.late_samples == ref.late_samples


# ------------------------------------------------------------ route_events
def _route_fields_equal(a, b):
    assert a._fields == b._fields
    np.testing.assert_array_equal(a.slot_ids, b.slot_ids)
    assert a.slot_ids.dtype == b.slot_ids.dtype
    assert (a.watermark, a.head, a.opened, a.n_dropped, a.n_late, a.min_window) == \
        (b.watermark, b.head, b.opened, b.n_dropped, b.n_late, b.min_window)
    assert len(a.overlap_slots) == len(b.overlap_slots)
    for x, y in zip(a.overlap_slots, b.overlap_slots):
        np.testing.assert_array_equal(x, y)
        assert x.dtype == y.dtype


_SPECS = {
    "tumbling": (10.0, 4, 20.0, None),
    "tumbling_strict": (5.0, 3, 0.0, None),
    "sliding": (6.0, 6, 4.0, 2.0),
    "sliding_wide": (12.0, 8, 8.0, 3.0),
}


def _stream_batches(seed, spec, steps=5):
    """Seeded batches: an advancing clock, late events, far-late drops, a jump past
    the ring in some streams, and an empty batch in some."""
    rng = np.random.RandomState(seed)
    clock, out = rng.uniform(0, 30), []
    for step in range(steps):
        n = int(rng.randint(0, 3) == 0) * 0 + int(rng.randint(1, 40))
        if seed % 7 == 3 and step == 2:
            n = 0
        if seed % 5 == 1 and step == 3:
            clock += spec.num_windows * spec.stride * 3  # past the whole ring
        clock += rng.uniform(0, 2 * spec.stride)
        times = clock - np.abs(rng.normal(0, spec.window_s, n)) * (rng.rand(n) < 0.4)
        out.append(times)
    return out


@pytest.mark.parametrize("mode", sorted(_SPECS))
@pytest.mark.parametrize("seed", range(20))
def test_route_events_bit_equal_to_jax(mode, seed):
    """Four spec kinds x 20 seeds x 4 forms (local clock, agreed clock,
    judge_prefix over a concatenation, a raw first batch) = 320 streams."""
    wj, nw, late, slide = _SPECS[mode]
    js, ps = jstream.WindowSpec(wj, nw, late, slide).validate(), pstream.WindowSpec(wj, nw, late, slide).validate()
    assert (ps.stride, ps.overlap, ps.window_start(7)) == (js.stride, js.overlap, js.window_start(7))
    batches = _stream_batches(seed, js)
    # the local clock, batch by batch
    wm = head = None
    for times in batches:
        a, b = pstream.route_events(times, wm, head, ps), jstream.route_events(times, wm, head, js)
        _route_fields_equal(a, b)
        wm, head = b.watermark, b.head
    # an agreed clock behind the local one
    wm = head = None
    rng = np.random.RandomState(1000 + seed)
    for times in batches:
        agreed = None if wm is None else wm - rng.uniform(0, 3 * js.stride)
        a = pstream.route_events(times, wm, head, ps, agreed=agreed)
        b = jstream.route_events(times, wm, head, js, agreed=agreed)
        _route_fields_equal(a, b)
        wm, head = b.watermark, b.head
    # judge_prefix: the concatenation of the first two batches
    first = np.concatenate(batches[:2])
    if first.size:
        prefix = np.concatenate([np.full(len(t), np.max(np.concatenate(batches[: i + 1])) if
                                          np.concatenate(batches[: i + 1]).size else -np.inf)
                                 for i, t in enumerate(batches[:2])])
        prefix = np.maximum.accumulate(prefix)
        if prefix[-1] == first.max():
            _route_fields_equal(pstream.route_events(first, None, None, ps, judge_prefix=prefix),
                                jstream.route_events(first, None, None, js, judge_prefix=prefix))
    # window_index and decay_scale
    t = np.concatenate(batches)
    np.testing.assert_array_equal(pstream.window_index(t, js.stride), jstream.window_index(t, js.stride))
    np.testing.assert_array_equal(pstream.decay_scale(t, 7.5), jstream.decay_scale(t, 7.5))


def test_route_events_errors_equal_jax():
    spec_p, spec_j = pstream.WindowSpec(10.0, 4, 10.0), jstream.WindowSpec(10.0, 4, 10.0)
    cases = [
        dict(event_times=[1.0, float("nan")], watermark=None, head=None),
        dict(event_times=[1.0, 2.0], watermark=None, head=None, agreed=1.0, judge_prefix=[1.0, 2.0]),
        dict(event_times=[1.0, 2.0], watermark=None, head=None, judge_prefix=[1.0]),
        dict(event_times=[1.0, 2.0], watermark=None, head=None, judge_prefix=[2.0, 1.0]),
        dict(event_times=[1.0, 2.0], watermark=None, head=None, judge_prefix=[1.0, 1.5]),
    ]
    for case in cases:
        with pytest.raises(ValueError) as ej:
            jstream.route_events(spec=spec_j, **case)
        with pytest.raises(ValueError) as ep:
            pstream.route_events(spec=spec_p, **case)
        assert str(ep.value) == str(ej.value)


@pytest.mark.parametrize("args", [
    (0.0, 4), (-1.0, 4), ("10", 4), (10.0, 0), (10.0, 2.5), (10.0, 4, -1.0), (10.0, 4, 31.0),
    (10.0, 4, 0.0, 0.0), (10.0, 4, 0.0, 11.0), (10.0, 4, 0.0, 3.0), (10.0, 2, 0.0, 2.0), (10.0, 4, 11.0, 5.0),
])
def test_window_spec_validate_errors_equal_jax(args):
    with pytest.raises(ValueError) as ej:
        jstream.WindowSpec(*args).validate()
    with pytest.raises(ValueError) as ep:
        pstream.WindowSpec(*args).validate()
    assert str(ep.value) == str(ej.value)


# ------------------------------------------------------------- Windowed
def _event_stream(seed, steps, n, stride, late_share=0.1, drop_share=0.05, horizon=4):
    rng = np.random.RandomState(seed)
    out = []
    for step in range(steps):
        base = step * stride * 0.7
        t = base + rng.uniform(0, stride, n)
        late = rng.rand(n) < late_share
        t[late] -= rng.uniform(0, stride * horizon * 0.5, late.sum())
        drop = rng.rand(n) < drop_share
        t[drop] -= rng.uniform(stride * horizon * 2, stride * horizon * 3, drop.sum())
        preds = rng.rand(n).astype(np.float32)
        labels = (rng.rand(n) < 0.4).astype(np.int64)
        target = (preds + rng.normal(0, 0.3, n)).astype(np.float32)
        probs = rng.dirichlet(np.ones(4), n).astype(np.float32)
        classes = rng.randint(0, 4, n).astype(np.int64)
        slots = rng.randint(0, 6, n).astype(np.int64)
        slots[rng.rand(n) < 0.05] = 6  # out of range for K = 6
        out.append(dict(t=t, preds=preds, labels=labels, target=target, probs=probs, classes=classes, slots=slots))
    return out


def _inner(pkg, kind):
    extra = CPU if pkg is pt else {}
    if kind == "accuracy":
        return pkg.Accuracy(**extra)
    if kind == "mse":
        return pkg.MeanSquaredError(**extra)
    if kind == "auroc_sketch":
        return pkg.AUROC(approx="sketch", num_bins=BINS, **extra)
    if kind == "quantile":
        return pkg.Quantile(q=0.9, **extra)
    if kind == "keyed":
        return pkg.Keyed(pkg.Accuracy(**extra), num_slots=6)
    raise ValueError(kind)


def _feed(pkg, kind, batch):
    j = pkg is mt
    as_ = (lambda x, dt=None: jnp.asarray(x if dt is None else x.astype(dt))) if j else torch.from_numpy
    if kind == "accuracy":
        return (as_(batch["probs"]), as_(batch["classes"], np.int32) if j else as_(batch["classes"])), {}
    if kind == "keyed":
        slot = as_(batch["slots"], np.int32) if j else as_(batch["slots"])
        return (as_(batch["probs"]), as_(batch["classes"], np.int32) if j else as_(batch["classes"])), {"slot": slot}
    if kind == "auroc_sketch":
        return (as_(batch["preds"]), as_(batch["labels"], np.int32) if j else as_(batch["labels"])), {}
    if kind == "quantile":
        return (as_(batch["preds"]),), {}
    return (as_(batch["preds"]), as_(batch["target"])), {}


_MODES = {
    "ring": dict(window_s=10.0, num_windows=4, allowed_lateness_s=20.0),
    "ring_strict": dict(window_s=10.0, num_windows=3),
    "sliding": dict(window_s=6.0, slide_s=2.0, num_windows=6, allowed_lateness_s=4.0),
    "decay": dict(decay_half_life_s=15.0),
    "decay_lateness": dict(decay_half_life_s=15.0, allowed_lateness_s=12.0),
}
_CASES = [(m, k) for m in ("ring", "ring_strict", "sliding") for k in ("accuracy", "mse", "auroc_sketch", "quantile",
                                                                        "keyed")] + \
    [(m, k) for m in ("decay", "decay_lateness") for k in ("accuracy", "mse")]


def _value_rtol(kind):
    return RTOL_SKETCH if kind in ("auroc_sketch", "quantile") else RTOL


@pytest.mark.parametrize("mode, kind", _CASES)
def test_windowed_equals_jax_step_by_step(mode, kind):
    stride = _MODES[mode].get("slide_s", _MODES[mode].get("window_s", 10.0))
    stream = _event_stream(zlib.crc32(f"{mode}-{kind}".encode()) % 1000, steps=6, n=48, stride=stride)
    port = pt.Windowed(_inner(pt, kind), **_MODES[mode])
    ref = mt.Windowed(_inner(mt, kind), **_MODES[mode])
    pcounters.reset()
    jcounters.reset()
    for batch in stream:
        if kind == "quantile":
            # the JAX package's float32-log qsketch bucket is off near a bucket edge (ROADMAP section 3): the
            # parity holds off that band, as in test_torch_quantile.py
            spec = next(iter(port.metric._defaults.values()))  # the inner Quantile's QSketchSpec
            keep = ~_near_edge(batch["preds"], (spec.alpha, spec.min_value, spec.max_value))
            batch = {k: v[keep] for k, v in batch.items()}
        pa, pk = _feed(pt, kind, batch)
        ja, jk = _feed(mt, kind, batch)
        port.update(*pa, event_time=batch["t"], **pk)
        ref.update(*ja, event_time=batch["t"], **jk)
        _assert_states(port, ref)
        _assert_position(port, ref)
        _assert_values(port.compute(), ref.compute(), _value_rtol(kind))
        for w in ref.resident_windows():
            _assert_values(port.compute_window(w), ref.compute_window(w), _value_rtol(kind))
    assert pcounters.snapshot()["slab_dropped_samples"] == jcounters.snapshot()["slab_dropped_samples"]
    assert port.dropped_samples > 0 or mode.startswith("decay") and "lateness" not in mode


def test_windowed_keyed_counts_misrouted_slot_ids_as_jax():
    stream = _event_stream(5, steps=3, n=40, stride=10.0, drop_share=0.0)
    port = pt.Windowed(_inner(pt, "keyed"), window_s=10.0, num_windows=4, allowed_lateness_s=20.0)
    pcounters.reset()
    for batch in stream:
        args, kw = _feed(pt, "keyed", batch)
        port.update(*args, event_time=batch["t"], **kw)
    want = sum(int((b["slots"] >= 6).sum()) for b in stream)
    assert want > 0 and pcounters.snapshot()["slab_dropped_samples"] == want + port.dropped_samples


def test_forward_rolls_the_accumulator_and_equals_update_where_jax_does_not():
    """The JAX package's forward runs the update on a fresh delta and sums it into
    the accumulator, so its roll never resets the accumulated slots (ROADMAP
    section 3): 4 windows through a 2-window ring give 7.5 there, 12.5 here."""
    fwd = pt.Windowed(pt.MeanSquaredError(**CPU), window_s=1.0, num_windows=2)
    upd = pt.Windowed(pt.MeanSquaredError(**CPU), window_s=1.0, num_windows=2)
    jfwd = mt.Windowed(mt.MeanSquaredError(), window_s=1.0, num_windows=2)
    for i in range(4):
        p, t = np.float32([i + 1.0]), np.float32([0.0])
        value = fwd(torch.from_numpy(p), torch.from_numpy(t), event_time=[i + 0.5])
        assert float(value) == (i + 1.0) ** 2
        upd.update(torch.from_numpy(p), torch.from_numpy(t), event_time=[i + 0.5])
        jfwd(jnp.asarray(p), jnp.asarray(t), event_time=np.array([i + 0.5]))
    assert float(fwd.compute()) == float(upd.compute()) == 12.5
    assert float(jfwd.compute()) == 7.5
    _assert_states(fwd, upd)


def test_decay_matches_closed_form_float64():
    m = pt.Windowed(pt.MeanSquaredError(**CPU), decay_half_life_s=10.0)
    preds = [np.float32([1.0]), np.float32([3.0]), np.float32([2.0])]
    times = [0.0, 10.0, 25.0]
    for p, t in zip(preds, times):
        m.update(torch.from_numpy(p), torch.zeros(1), event_time=[t])
    w = 0.5 ** ((25.0 - np.asarray(times)) / 10.0)
    want = float((w * np.array([1.0, 9.0, 4.0])).sum() / w.sum())
    np.testing.assert_allclose(float(m.compute()), want, rtol=RTOL)


def test_sliding_compute_is_the_trailing_full_span_window():
    m = pt.Windowed(pt.Accuracy(**CPU), window_s=4.0, num_windows=4, slide_s=2.0)
    m.update(torch.tensor([0.9, 0.1]), torch.tensor([1, 1]), event_time=np.array([1.0, 5.0]))
    assert m.head_window == 2 and float(m.compute()) == float(m.compute_window(1)) == 0.0
    m.update(torch.tensor([0.9]), torch.tensor([1]), event_time=np.array([6.9]))
    assert m.head_window == 3 and float(m.compute_window(3)) == 1.0 and float(m.compute()) == 0.5


# ------------------------------------------------- partials and checkpoints
def _to_jax_partial(partial):
    """The port's partial in the JAX package's types: sketch leaves map by class name."""
    kinds = {"HistogramSketch": jsk.HistogramSketch, "RankSketch": jsk.RankSketch,
             "QuantileSketch": jqs.QuantileSketch}
    state = {k: kinds[type(v).__name__](np.asarray(v.counts)) if hasattr(v, "counts") else v
             for k, v in partial["state"].items()}
    return {**partial, "state": state}


@pytest.mark.parametrize("kind", ["accuracy", "auroc_sketch", "keyed"])
def test_window_partials_cross_both_ways(kind):
    stream = _event_stream(7, steps=3, n=40, stride=10.0)
    port = pt.Windowed(_inner(pt, kind), window_s=10.0, num_windows=4, allowed_lateness_s=20.0)
    ref = mt.Windowed(_inner(mt, kind), window_s=10.0, num_windows=4, allowed_lateness_s=20.0)
    for batch in stream:
        pa, pk = _feed(pt, kind, batch)
        ja, jk = _feed(mt, kind, batch)
        port.update(*pa, event_time=batch["t"], **pk)
        ref.update(*ja, event_time=batch["t"], **jk)
    windows = ref.resident_windows()
    jparts = [ref.window_partial(w) for w in windows]
    pparts = [_to_jax_partial(port.window_partial(w)) for w in windows]
    for pp, jp in zip(pparts, jparts):
        assert pp["version"] == jp["version"] == 1 and pp["window"] == jp["window"]
        assert pp["window_start_s"] == jp["window_start_s"]
        np.testing.assert_array_equal(pp["rows"], jp["rows"])
    rtol = _value_rtol(kind)
    fresh_p = pt.Windowed(_inner(pt, kind), window_s=10.0, num_windows=4, allowed_lateness_s=20.0)
    fresh_j = mt.Windowed(_inner(mt, kind), window_s=10.0, num_windows=4, allowed_lateness_s=20.0)
    for w, jp, pp in zip(windows, jparts, pparts):
        _assert_values(fresh_p.value_from_partials([jp]), ref.compute_window(w), rtol)  # JAX partial, port merge
        _assert_values(fresh_j.value_from_partials([pp]), port.compute_window(w), rtol)  # and the reverse
    _assert_values(fresh_p.value_from_partials(jparts), fresh_j.value_from_partials(pparts), rtol)
    _assert_values(fresh_p.value_from_partials([]), fresh_j.value_from_partials([]), rtol)
    with pytest.raises(ValueError, match="version mismatch"):
        fresh_p.merge_partials([dict(jparts[0], version=2)])


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("kind", ["accuracy", "auroc_sketch", "mse_decay"])
def test_state_dict_crosses_both_ways_and_resumes_mid_window(direction, kind):
    inner_kind = "mse" if kind == "mse_decay" else kind
    cfg = dict(decay_half_life_s=15.0) if kind == "mse_decay" else dict(window_s=10.0, num_windows=4,
                                                                        allowed_lateness_s=20.0)
    stream = _event_stream(11, steps=6, n=40, stride=10.0)
    whole_p, whole_j = pt.Windowed(_inner(pt, inner_kind), **cfg), mt.Windowed(_inner(mt, inner_kind), **cfg)
    first_p, first_j = pt.Windowed(_inner(pt, inner_kind), **cfg), mt.Windowed(_inner(mt, inner_kind), **cfg)
    for i, batch in enumerate(stream):
        pa, pk = _feed(pt, inner_kind, batch)
        ja, jk = _feed(mt, inner_kind, batch)
        whole_p.update(*pa, event_time=batch["t"], **pk)
        whole_j.update(*ja, event_time=batch["t"], **jk)
        if i < 3:
            first_p.update(*pa, event_time=batch["t"], **pk)
            first_j.update(*ja, event_time=batch["t"], **jk)
    if direction == "jax_to_port":
        resumed = pt.Windowed(_inner(pt, inner_kind), **cfg)
        resumed.load_state_dict(first_j.state_dict())
        feed, whole = pt, whole_p
    else:
        resumed = mt.Windowed(_inner(mt, inner_kind), **cfg)
        resumed.load_state_dict(first_p.state_dict())
        feed, whole = mt, whole_j
    keys = {k for k in first_p.state_dict() if k.startswith("_windowed_")}
    assert keys == {k for k in first_j.state_dict() if k.startswith("_windowed_")} and len(keys) == 6
    for batch in stream[3:]:
        a, k = _feed(feed, inner_kind, batch)
        resumed.update(*a, event_time=batch["t"], **k)
    _assert_states(resumed, whole)
    _assert_position(resumed, whole)
    _assert_values(resumed.compute(), whole.compute(), _value_rtol(inner_kind))


def test_pickle_and_reset_and_repr():
    m = pt.Windowed(pt.Accuracy(**CPU), window_s=10.0, num_windows=4, allowed_lateness_s=5.0, slide_s=5.0)
    j = mt.Windowed(mt.Accuracy(), window_s=10.0, num_windows=4, allowed_lateness_s=5.0, slide_s=5.0)
    m.update(torch.tensor([0.9, 0.2]), torch.tensor([1, 1]), event_time=[3.0, 12.0])
    revived = pickle.loads(pickle.dumps(m))
    assert revived.watermark == 12.0 and revived.resident_windows() == m.resident_windows()
    _assert_states(revived, m)
    assert repr(m).replace("(device=cpu)", "()") == repr(j)
    d, jd = pt.Windowed(pt.MeanSquaredError(**CPU), decay_half_life_s=3.0), mt.Windowed(mt.MeanSquaredError(),
                                                                                       decay_half_life_s=3.0)
    assert repr(d).replace("(device=cpu)", "()") == repr(jd)
    m.reset()
    assert m.watermark is None and m.head_window is None and m.resident_windows() == () and m.dropped_samples == 0
    assert int(m.windowed_rows.sum()) == 0 and m.lifecycle_label is None


@pytest.mark.parametrize("empty", ["nan", "zero"])
def test_empty_policy_stride_and_window_start_equal_jax(empty):
    port = pt.Windowed(pt.Accuracy(**CPU), window_s=10.0, num_windows=4, slide_s=5.0, empty=empty)
    ref = mt.Windowed(mt.Accuracy(), window_s=10.0, num_windows=4, slide_s=5.0, empty=empty)
    _assert_values(port.compute(), ref.compute())  # nothing resident yet
    assert port.window_stride == ref.window_stride == 5.0 and port.window_start(3) == ref.window_start(3) == 15.0
    port.update(torch.tensor([0.9]), torch.tensor([1]), event_time=[12.0])
    ref.update(jnp.asarray(np.float32([0.9])), jnp.asarray(np.int32([1])), event_time=np.array([12.0]))
    assert port.resident_windows() == ref.resident_windows() == (1, 2)
    for w in (1, 2):
        _assert_values(port.compute_window(w), ref.compute_window(w))
    decay = pt.Windowed(pt.MeanSquaredError(**CPU), decay_half_life_s=5.0, empty=empty)
    _assert_values(decay.compute(), mt.Windowed(mt.MeanSquaredError(), decay_half_life_s=5.0, empty=empty).compute())
    assert decay.window_stride is None and decay.head_window is None and decay.resident_windows() == ()
    with pytest.raises(ValueError, match="no windows"):
        decay.window_start(0)


def test_constructor_and_update_errors_equal_jax():
    bad = [
        dict(),
        dict(window_s=1.0, decay_half_life_s=1.0),
        dict(window_s=1.0, empty="inf"),
        dict(decay_half_life_s=-1.0),
        dict(decay_half_life_s=1.0, slide_s=0.5),
        dict(window_s=1.0, num_windows=2, allowed_lateness_s=5.0),
        dict(window_s=1.0, rank=3),
    ]
    for kw in bad:
        with pytest.raises(ValueError) as ej:
            mt.Windowed(mt.Accuracy(), **kw)
        with pytest.raises(ValueError) as ep:
            pt.Windowed(pt.Accuracy(**CPU), **kw)
        assert str(ep.value) == str(ej.value), kw
    with pytest.raises(ValueError, match="cat/list/buffer"):
        pt.Windowed(pt.AUROC(**CPU), window_s=1.0)
    with pytest.raises(ValueError, match="sketch state"):
        pt.Windowed(pt.AUROC(approx="sketch", **CPU), decay_half_life_s=1.0)
    with pytest.raises(ValueError, match="segment slab"):
        pt.Windowed(pt.Keyed(pt.Accuracy(**CPU), 3), decay_half_life_s=1.0)
    m = pt.Windowed(pt.Accuracy(**CPU), window_s=1.0)
    with pytest.raises(ValueError, match="event_time"):
        m.update(torch.tensor([0.5]), torch.tensor([1]))
    with pytest.raises(ValueError, match="entries"):
        m.update(torch.tensor([0.5, 0.2]), torch.tensor([1, 0]), event_time=[1.0, 2.0, 3.0])
    with pytest.raises(KeyError):
        m.compute_window(5)
    with pytest.raises(ValueError, match="no windows"):
        pt.Windowed(pt.MeanSquaredError(**CPU), decay_half_life_s=1.0).compute_window(0)


def test_update_under_vmap_raises_tracing_unsupported():
    m = pt.Windowed(pt.Accuracy(**CPU), window_s=1.0)

    def one(p, t):
        m.update(p, t, event_time=torch.zeros(p.shape[0]))
        return p

    with pytest.raises(TracingUnsupportedError):
        torch.func.vmap(one)(torch.rand(3, 2), torch.randint(0, 2, (3, 2)))
    keyed = pt.Keyed(pt.Accuracy(**CPU), 4, lru=True)
    with pytest.raises(TracingUnsupportedError):
        torch.func.vmap(lambda p, t, s: keyed.update_state(keyed.init_state(), p, t, slot=s)["keyed_rows"])(
            torch.rand(3, 2), torch.randint(0, 2, (3, 2)), torch.randint(0, 4, (3, 2)))


def test_keyed_under_vmap_drops_out_of_range_ids_with_scatter_rules():
    """The nested per-sample delta: Keyed's update under vmap reads nothing and
    scatters with scatter_add (one operation, not one per sample)."""
    keyed = pt.Keyed(pt.MeanSquaredError(**CPU), 4)
    preds, target = torch.rand(32, 1), torch.rand(32, 1)
    slots = torch.tensor([[i % 6 - 1] for i in range(32)])

    def one(p, t, s):
        return keyed.update_state(keyed.init_state(), p, t, slot=s)

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = torch.func.vmap(one)(preds, target, slots)
    names = {e.key: e.count for e in prof.key_averages()}
    assert names.get("aten::index_add", 0) == 0 and names.get("aten::index_add_", 0) == 0
    for i in range(32):
        s = int(slots[i, 0])
        want = np.zeros(4, np.float32)
        if 0 <= s < 4:
            want[s] = float((preds[i, 0] - target[i, 0]) ** 2)
        np.testing.assert_allclose(_np(out["sum_squared_error"][i]), want, rtol=RTOL)
        assert int(out["keyed_rows"][i].sum()) == int(0 <= s < 4)


# ------------------------------------------------------------ the agreement
def _two_ranks(pkg, **kw):
    args = dict(window_s=10.0, num_windows=4, allowed_lateness_s=10.0)
    args.update(kw)
    ag = pkg.WatermarkAgreement(deadline_s=30.0)
    extra = CPU if pkg is pt else {}
    a = pkg.Windowed(pkg.Accuracy(**extra), **args, agreement=ag, rank=0)
    b = pkg.Windowed(pkg.Accuracy(**extra), **args, agreement=ag, rank=1)
    return ag, a, b


def _one(pkg, pred=0.9):
    if pkg is mt:
        return jnp.asarray(np.float32([pred])), jnp.asarray(np.int32([1]))
    return torch.tensor([pred]), torch.tensor([1])


@pytest.mark.parametrize("pkg", [pt, mt], ids=["port", "jax"])
def test_agreed_clock_keeps_peer_fed_windows_open(pkg):
    ag, fast, slow = _two_ranks(pkg, num_windows=8)
    fast.update(*_one(pkg), event_time=[45.0])
    slow.update(*_one(pkg, 0.8), event_time=[12.0])
    assert ag.agreed() == 12.0
    fast.update(*_one(pkg, 0.7), event_time=[5.0])
    assert fast.dropped_samples == 0 and _np(fast._current_state()["windowed_rows"])[0] == 1
    lone = pkg.Windowed(pkg.Accuracy(**(CPU if pkg is pt else {})), window_s=10.0, num_windows=8,
                        allowed_lateness_s=10.0)
    lone.update(*_one(pkg), event_time=[45.0])
    lone.update(*_one(pkg, 0.7), event_time=[5.0])
    assert lone.dropped_samples == 1


@pytest.mark.parametrize("pkg", [pt, mt], ids=["port", "jax"])
def test_close_watermark_is_agreed_and_monotone(pkg):
    ag, a, b = _two_ranks(pkg)
    assert a.close_watermark is None
    a.update(*_one(pkg), event_time=[30.0])
    assert a.close_watermark is None
    b.update(*_one(pkg), event_time=[8.0])
    assert a.close_watermark == 8.0 and b.close_watermark == 8.0
    b.update(*_one(pkg), event_time=[25.0])
    assert a.close_watermark == 25.0 and a.agreed_watermark == 25.0 and not a.agreement_degraded


def test_agreement_checkpoint_round_trip_across_packages():
    """A port rank restored from a JAX rank's checkpoint rejoins a fresh
    agreement at the checkpointed clock, never lower."""
    jag, ja, jb = _two_ranks(mt)
    ja.update(jnp.asarray(np.float32([0.9, 0.2])), jnp.asarray(np.int32([1, 0])), event_time=np.array([12.0, 15.0]))
    jb.update(jnp.asarray(np.float32([0.9, 0.2])), jnp.asarray(np.int32([1, 0])), event_time=np.array([33.0, 35.0]))
    assert jag.agreed() == 15.0
    snap = ja.state_dict()
    ag2 = pt.WatermarkAgreement(deadline_s=30.0)
    restored = pt.Windowed(pt.Accuracy(**CPU), window_s=10.0, num_windows=4, allowed_lateness_s=10.0, agreement=ag2,
                           rank=0)
    peer = pt.Windowed(pt.Accuracy(**CPU), window_s=10.0, num_windows=4, allowed_lateness_s=10.0, agreement=ag2,
                       rank=1)
    peer.update(torch.tensor([0.9, 0.2]), torch.tensor([1, 0]), event_time=np.array([33.0, 35.0]))
    restored.load_state_dict(snap)
    assert ag2.agreed() == 15.0 and restored.agreed_watermark == 15.0 and restored.close_watermark == 15.0
    assert int(restored.windowed_rows.sum()) == 2
    restored.update(torch.tensor([0.9, 0.2]), torch.tensor([1, 0]), event_time=np.array([18.0, 21.0]))
    assert ag2.agreed() == 21.0


def test_agreement_deepcopy_shares_pickle_drops():
    ag, a, _b = _two_ranks(pt)
    twin = copy.deepcopy(a)
    assert twin.agreement is ag and copy.deepcopy(ag) is ag
    a.update(*_one(pt), event_time=[9.0])
    revived = pickle.loads(pickle.dumps(a))
    assert revived.agreement is None and revived.watermark == 9.0
    with pytest.raises(TypeError, match="cannot be pickled"):
        pickle.dumps(ag)
    assert repr(ag).startswith("WatermarkAgreement(label=") and "ranks=2" in repr(ag)


def test_late_verdicts_judged_by_the_agreed_clock():
    spec = pstream.WindowSpec(10.0, 8, 10.0)
    r = pstream.route_events([45.0], None, None, spec)
    assert r.head == 4
    r2 = pstream.route_events([5.0], r.watermark, r.head, spec, agreed=8.0)
    assert list(r2.slot_ids) == [0] and r2.n_late == 0
    r3 = pstream.route_events([5.0], r.watermark, r.head, spec, agreed=12.0)
    assert list(r3.slot_ids) == [0] and r3.n_late == 1
    r4 = pstream.route_events([5.0], r.watermark, r.head, spec, agreed=-math.inf)
    assert list(r4.slot_ids) == [0] and r4.n_late == 0


@pytest.mark.parametrize("pkg", [pt, mt], ids=["port", "jax"])
def test_straggler_exclusion_rejoin_and_reregistration(pkg):
    counters = pcounters if pkg is pt else jcounters
    before = counters.snapshot()["wm_stragglers"]
    # a deadline far above the gap between two consecutive calls here, even on a loaded host
    ag = pkg.WatermarkAgreement(deadline_s=1.0)
    ag.register(0)
    ag.register(1)
    ag.report(0, 50.0)
    ag.report(1, 10.0)
    assert ag.agreed() == 10.0
    time.sleep(1.3)
    ag.report(0, 55.0)
    assert ag.agreed() == 55.0 and ag.excluded() == (1,) and ag.degraded and ag.stragglers == 1
    assert counters.snapshot()["wm_stragglers"] == before + 1  # recorded with counting off
    ag.report(1, 10.0)  # an equal report is no advance
    assert ag.excluded() == (1,)
    ag.register(1)
    assert ag.excluded() == () and not ag.degraded and ag.agreed() == 55.0
    time.sleep(1.3)
    ag.report(0, 60.0)
    assert ag.excluded() == (1,) and ag.stragglers == 2
    ag.report(1, 70.0)  # an advance rejoins at the next agreement
    assert ag.agreed() == 60.0 and ag.excluded() == ()
    assert ag.local_watermarks() == {0: 60.0, 1: 70.0} and ag.ranks() == (0, 1)


def test_raise_policy_and_constructor_errors():
    ag = pt.WatermarkAgreement(deadline_s=0.05, policy="raise")
    ag.report("a", 1.0)
    time.sleep(0.1)
    with pytest.raises(SyncTimeoutError) as err:
        ag.agreed()
    assert isinstance(err.value, TimeoutError)
    for kw in (dict(deadline_s=0), dict(policy="ignore"), dict(exchange_every_s=-1.0)):
        with pytest.raises(ValueError) as ej:
            jstream.WatermarkAgreement(**kw)
        with pytest.raises(ValueError) as ep:
            pstream.WatermarkAgreement(**kw)
        assert str(ep.value) == str(ej.value)
    assert pstream.WatermarkAgreement(deadline_s=None).deadline_s is None


def test_exchange_in_one_process_is_counted_and_resolved():
    pcounters.reset()
    pcounters.enable()
    try:
        ag = pt.WatermarkAgreement(deadline_s=30.0, exchange_every_s=3600.0, label="wm/test")
        assert ag.exchange() is None  # no local min yet
        ag.report(0, 20.0)
        ag.report(1, 12.0)
        handle = ag.exchange()
        assert handle.done() and float(handle.result()["wm"]) == 12.0
        ag.drain(1.0)
        snap = pcounters.snapshot()
        assert snap["wm_exchange_calls"] == 1 and ag.exchanges == 1
        assert snap["watermark_agreement"]["wm/test"] == {"agreed": None, "ranks": 2, "excluded": [],
                                                          "exchanges": 1}
        assert ag.agreed() == 12.0
    finally:
        pcounters.disable()
        pcounters.reset()


def test_exports_match_jax():
    import metrics_tpu.wrappers as jw
    import metrics_tpu_torch.wrappers as pw

    assert pt.Windowed is pw.Windowed and "Windowed" in pw.__all__ and hasattr(jw, "Windowed")
    assert pt.WatermarkAgreement is pstream.WatermarkAgreement and hasattr(mt, "WatermarkAgreement")
    for name in jstream.__all__:
        assert name in pstream.__all__, name
    import metrics_tpu_torch.observability as pobs
    import metrics_tpu.observability as jobs

    assert pobs.COUNTERS is pcounters.COUNTERS and isinstance(pobs.COUNTERS, pobs.CollectiveCounters)
    assert hasattr(jobs, "COUNTERS") and hasattr(jobs, "CollectiveCounters")
    from metrics_tpu.utils import exceptions as jexc
    from metrics_tpu_torch.utils import exceptions as pexc

    for name in jexc.__all__:
        if name != "MetricsTPUError":
            assert issubclass(getattr(pexc, name), pexc.MetricsTorchError), name
    assert issubclass(pexc.SyncTimeoutError, TimeoutError)
