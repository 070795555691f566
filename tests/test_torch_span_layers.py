"""The port's spans at each layer of a collection step, their clock, and the idle attribution.

* A ``MetricCollection([SSIM, PSNR, UniversalImageQualityIndex])`` forward
  with a ``dist_sync_fn`` records the step's tree: ``collection.forward`` at
  the root, ``collection.lockstep`` before and after the members, and per
  member ``metric.forward`` > ``metric.forward_update``, ``metric.compute`` >
  ``metric.sync_state``; each span carries its parent's id and the root's id.
* ``collection.lockstep`` is recorded in ``forward``, ``update`` and the epoch
  ``compute``, with the list elements it walked.
* A shared compute group records ``collection.group_update`` and
  ``collection.step_sync`` under the root.
* In a one-rank Gloo group the members' packed step sync: one
  ``collection.step_sync`` (``members``) after a ``metric.forward`` range a
  member, in member order, each holding its member's update ops; the
  collective in the sync's range alone; its idle time in the ``sync`` layer.
* The layers' self times (``devtime.span_self_ms``) add up to the root's
  duration.
* A real CPU ``torch.profiler`` session through ``start_trace`` /
  ``stop_trace``: every span record joins its ``record_function`` scope by
  name and mapped start within ``devtime.JOIN_TOLERANCE_US``; the last
  session is kept for ``idle_attribution``'s defaults.
* A hand-written trace with known kernels and gaps: each gap's ms goes to the
  right span and layer, ``outside`` where the host was in no span.
* ``from_profiler_trace`` counts the port's own spans to no phase of their
  own (a ``metric.forward_update`` device event to ``metric.forward``).

Tolerances: names, parents, depths, ids and counts are equal; self times add
up within 2 us a span; the hand-written trace's ms are exact to 1e-9.
"""
import collections
import json
import threading

import pytest
import torch

import metrics_tpu_torch as pt
import metrics_tpu_torch.observability as pobs
from metrics_tpu_torch.observability import devtime as pdevtime
from metrics_tpu_torch.observability import profiler as pprofiler
from metrics_tpu_torch.observability.trace import SpanRecord
from tests.test_torch_faults import plane_hygiene  # noqa: F401  (autouse: every test leaves the process clean)
from tests.test_torch_observability import obs_hygiene  # noqa: F401  (autouse: observability off and empty)

torch.set_num_threads(1)
CPU = {"device": "cpu"}


def _gather(x):
    return [x, x]


def _images(seed=0, n=2, size=24):
    g = torch.Generator().manual_seed(seed)
    target = torch.rand((n, 3, size, size), generator=g)
    return (target + 0.05 * torch.randn((n, 3, size, size), generator=g)).clamp(0, 1), target


def _image_collection(gather=_gather):
    col = pt.MetricCollection([pt.SSIM(data_range=1.0, kernel_size=(5, 5), **CPU), pt.PSNR(data_range=1.0, **CPU),
                               pt.UniversalImageQualityIndex(kernel_size=(5, 5), **CPU)])
    for m in col.values():
        m.dist_sync_fn, m.dist_sync_on_step = gather, True
    return col


def _traced(fn):
    pobs.enable(spans=True, counters=False)
    try:
        fn()
        return pobs.records()
    finally:
        pobs.disable()
        pobs.reset()


def _shape(records):
    """(name, parent, depth, metric) of each record, with the parent's name read through its id."""
    by_id = {r.span_id: r for r in records}
    return [(r.name, by_id[r.parent_id].name if r.parent_id is not None else None, r.depth,
             (r.attrs or {}).get("metric")) for r in records]


# ------------------------------------------------------------- the step's tree
def test_collection_step_records_the_tree_with_one_root_id():
    col = _image_collection()
    preds, target = _images()
    col(preds, target)  # built and warm: the traced steps below are steady ones
    records = _traced(lambda: [col(preds, target) for _ in range(2)])
    roots = [r for r in records if r.name == "collection.forward"]
    assert len(roots) == 2 and all(r.depth == 0 and r.parent is None and r.parent_id is None for r in roots)
    assert all(r.root_id == r.span_id and r.attrs == {"members": 3} for r in roots)
    for root in roots:
        step = sorted((r for r in records if r.root_id == root.span_id), key=lambda r: r.start_ns)
        want = [("collection.forward", None, 0, None), ("collection.lockstep", "collection.forward", 1, None)]
        for member in ("SSIM", "PSNR", "UniversalImageQualityIndex"):
            want += [("metric.forward", "collection.forward", 1, member),
                     ("metric.forward_update", "metric.forward", 2, member),
                     ("metric.compute", "metric.forward", 2, member),
                     ("metric.sync_state", "metric.compute", 3, member)]
        want.append(("collection.lockstep", "collection.forward", 1, None))
        assert _shape(step) == want
        assert [r.parent for r in step[1:]] == [w[1] for w in want[1:]]
        assert all(root.start_ns <= r.start_ns and r.end_ns <= root.end_ns for r in step)
    assert {r.root_id for r in records} == {r.span_id for r in roots}
    assert len({r.span_id for r in records}) == len(records)


@pytest.mark.filterwarnings("ignore::UserWarning")  # the exact curves' O(samples) notice and pos_label's
def test_lockstep_spans_in_forward_update_and_compute():
    col = pt.MetricCollection([pt.AUROC(**CPU), pt.AveragePrecision(**CPU)])
    col.update(torch.rand(8), torch.randint(0, 2, (8,)))  # the list states hold a first batch

    def loop():
        col.update(torch.rand(8), torch.randint(0, 2, (8,)))
        col(torch.rand(8), torch.randint(0, 2, (8,)))
        col.compute()

    records = _traced(loop)
    lock = [r for r in records if r.name == "collection.lockstep"]
    by_id = {r.span_id: r for r in records}
    parents = [by_id[r.parent_id].name if r.parent_id is not None else None for r in lock]
    # update: check and record at the top level; forward: both under its root; compute: the epoch sync's check
    assert parents == [None, None, "collection.forward", "collection.forward", "collection.compute"]
    elements = [r.attrs["elements"] for r in lock]
    # two members, two list states each: one element a batch; the record after a batch holds one more
    assert elements == [4, 8, 8, 12, 12]


def test_shared_group_records_group_update_and_step_sync_under_the_root():
    col = pt.MetricCollection([pt.Precision(num_classes=3, average="macro", **CPU),
                               pt.Recall(num_classes=3, average="macro", **CPU)])
    for m in col.values():
        m.dist_sync_fn, m.dist_sync_on_step = _gather, True
    preds, target = torch.tensor([0, 1, 2, 2, 1]), torch.tensor([0, 2, 2, 1, 1])
    col(preds, target)
    assert col.compute_groups == {"Precision": ("Precision", "Recall")}
    records = _traced(lambda: col(preds, target))
    assert [s[:3] for s in _shape(sorted(records, key=lambda r: r.start_ns))] == [
        ("collection.forward", None, 0),
        ("collection.lockstep", "collection.forward", 1),
        ("collection.group_update", "collection.forward", 1),
        ("collection.step_sync", "collection.forward", 1),
        ("metric.compute", "collection.forward", 1),
        ("metric.compute", "collection.forward", 1),
        ("collection.lockstep", "collection.forward", 1),
    ]
    assert len({r.root_id for r in records}) == 1


def test_packed_step_records_one_step_sync_and_a_forward_range_a_member(tmp_path):
    """In a one-rank Gloo group the three members' deltas share one ``collection.step_sync``; each member's
    update ops lie in its own ``metric.forward`` range, one range a member in member order (what
    ``portbench/trace_reader.py`` matches to the members); the idle attribution puts the packed sync in ``sync``."""
    import torch.distributed as dist

    members = ("SSIM", "PSNR", "UniversalImageQualityIndex")
    col = _image_collection(gather=None)
    preds, target = _images(3)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
    try:
        col(preds, target)  # built and warm
        pobs.enable(spans=True, counters=False)
        pobs.start_trace(str(tmp_path))
        try:
            for _ in range(3):
                with torch.profiler.record_function("unit"):
                    col(preds, target)
        finally:
            path = pobs.stop_trace()
    finally:
        dist.destroy_process_group()
    records = sorted(pprofiler.last_session().records, key=lambda r: r.start_ns)
    roots = [r for r in records if r.name == "collection.forward"]
    assert len(roots) == 3
    want = [("collection.forward", None, 0, None), ("collection.lockstep", "collection.forward", 1, None)]
    for member in members:
        want += [("metric.forward", "collection.forward", 1, member),
                 ("metric.forward_update", "metric.forward", 2, member)]
    want.append(("collection.step_sync", "collection.forward", 1, None))
    want += [("metric.compute", "collection.forward", 1, member) for member in members]
    want.append(("collection.lockstep", "collection.forward", 1, None))
    for root in roots:
        step = [r for r in records if r.root_id == root.span_id]
        assert _shape(step) == want
        assert [r.attrs for r in step if r.name == "collection.step_sync"] == [{"group": "SSIM", "members": 3}]

    events = json.loads(open(path).read())["traceEvents"]
    scopes = sorted((e for e in events if e.get("cat") == "user_annotation"), key=lambda e: e["ts"])
    ops = [e for e in events if e.get("cat") == "cpu_op"]

    def inside(e, scope):
        return scope["ts"] <= e["ts"] and e["ts"] + e["dur"] <= scope["ts"] + scope["dur"]

    forwards = [e for e in scopes if e["name"] == "metric.forward"]
    updates = [e for e in scopes if e["name"] == "metric.forward_update"]
    names = [r.attrs["metric"] for r in records if r.name == "metric.forward"]
    assert names == list(members) * 3 and len(forwards) == len(updates) == len(names)
    for forward, update in zip(forwards, updates):
        assert inside(update, forward)
        assert any(inside(op, update) for op in ops)  # the member's update ops, launched in its range
    syncs = [e for e in scopes if e["name"] == "collection.step_sync"]
    reduces = [op for op in ops if op["name"] == "c10d::allreduce_"]
    assert len(syncs) == 3 and reduces and all(any(inside(op, sync) for sync in syncs) for op in reduces)
    assert not any(inside(op, forward) for op in reduces for forward in forwards)

    found = pdevtime.idle_attribution(path, records, pprofiler.last_session().anchors, window="unit",
                                      thread_id=threading.get_ident())
    assert found["clock"]["joined"] == len(records)
    idle = found["idle_ms"]
    assert "metric.sync_state" not in idle["by_span"] and idle["by_span"]["collection.step_sync"] > 0
    assert idle["by_layer"]["sync"] == pytest.approx(idle["by_span"]["collection.step_sync"], abs=1e-9)


def test_layer_self_times_add_up_to_the_root():
    col = _image_collection()
    preds, target = _images(1)
    col(preds, target)
    records = _traced(lambda: [col(preds, target) for _ in range(3)])
    for root in (r for r in records if r.name == "collection.forward"):
        step = [r for r in records if r.root_id == root.span_id]
        self_ms = pdevtime.span_self_ms(step)
        assert set(self_ms["by_layer"]) == {"runtime", "update", "sync"}
        assert all(ms >= 0 for ms in self_ms["by_span"].values())
        assert sum(self_ms["by_layer"].values()) == pytest.approx(root.duration_ms, abs=2e-3 * len(step))
        assert sum(self_ms["by_span"].values()) == pytest.approx(root.duration_ms, abs=2e-3 * len(step))


def test_layer_map_extends_the_phase_map():
    assert set(pdevtime.PHASE_OF_SPAN) <= set(pdevtime.LAYER_OF_SPAN)
    layers = collections.defaultdict(set)
    for name, layer in pdevtime.LAYER_OF_SPAN.items():
        layers[layer].add(name)
    assert {"metric.forward_update", "metric.update", "collection.group_update"} <= layers["update"]
    assert layers["sync"] == {"metric.sync_state", "collection.step_sync", "collection.host_sync"}
    assert {"collection.forward", "collection.lockstep", "collection.compute", "metric.forward",
            "metric.compute"} <= layers["runtime"]


# ------------------------------------------------------------------- the clock
def test_profiler_session_joins_every_span_with_its_scope(tmp_path):
    col = _image_collection()
    preds, target = _images(2)
    col(preds, target)
    pobs.enable(spans=True, counters=False)
    pobs.start_trace(str(tmp_path))
    try:
        for _ in range(4):
            with torch.profiler.record_function("unit"):
                col(preds, target)
    finally:
        path = pobs.stop_trace()
    session = pprofiler.last_session()
    assert len(session.anchors) == 2 and all(len(a) == pprofiler.ANCHOR_SCOPES for a in session.anchors)
    assert len(session.records) == 4 * 15  # the root, two lockstep spans, four spans a member
    events = json.loads(open(path).read())["traceEvents"]
    scopes = [e for e in events if e.get("cat") == "user_annotation"]
    assert sum(e["name"] == pprofiler.ANCHOR for e in scopes) == 2 * pprofiler.ANCHOR_SCOPES
    for name in ("collection.forward", "collection.lockstep", "metric.forward_update"):
        assert sum(e["name"] == name for e in scopes) == sum(r.name == name for r in session.records)
    found = pdevtime.idle_attribution(path, session.records, session.anchors, window="unit",
                                      thread_id=threading.get_ident())
    clock = found["clock"]
    assert clock["anchors"] == 2 and clock["spans"] == len(session.records) == clock["joined"]
    assert clock["join_widest_us"] <= pdevtime.JOIN_TOLERANCE_US
    # the defaults read the kept session: the same attribution
    assert pdevtime.idle_attribution(window="unit", thread_id=threading.get_ident()) == found
    # a CPU session has no device operation: the window is idle, all of it, and in the spans but between units
    idle = found["idle_ms"]["by_layer"]
    assert found["busy_ms"] == 0.0 and sum(idle.values()) == pytest.approx(found["window_ms"], rel=1e-9)
    assert set(idle) == {"runtime", "update", "sync", "outside"}
    assert idle["outside"] < 0.5 * found["window_ms"]
    pobs.disable()
    pobs.reset()
    assert pprofiler.last_session() is session  # reset() drops the recorded spans, not the stopped session


def test_idle_attribution_without_a_session_raises(monkeypatch):
    monkeypatch.setattr(pprofiler._SESSION, "last", None)
    with pytest.raises(ValueError, match="no profiler session"):
        pdevtime.idle_attribution()
    with pytest.raises(ValueError, match="no clock anchor"):
        pdevtime.idle_attribution([], [], [])


# ---------------------------------------------------- attribution on a known trace
def _rec(name, start_us, end_us, depth, span_id, parent_id, root_id=1):
    # perf_counter_ns = trace us * 1000 + 5e9: the clocks differ by an offset alone
    return SpanRecord(name, int(start_us * 1000 + 5e9), int(end_us * 1000 + 5e9), 7, depth, None, None, span_id,
                      parent_id, root_id)


def _hand_trace():
    anchor = pprofiler.ANCHOR
    events = [{"ph": "X", "cat": "user_annotation", "name": anchor, "ts": t, "dur": 1.0} for t in (1.0, 2.0, 3.0)]
    events += [{"ph": "X", "cat": "user_annotation", "name": anchor, "ts": t, "dur": 1.0} for t in (5001.0, 5002.0,
                                                                                                   5003.0)]
    # reads lag their scopes by 0.5 us except the second of each anchor, which entered at once
    anchors = [(int(1.5e3 + 5e9), int(2.0e3 + 5e9), int(3.5e3 + 5e9)), (int(5001.5e3 + 5e9), int(5002.0e3 + 5e9),
                                                                         int(5003.5e3 + 5e9))]
    records = [
        _rec("collection.forward", 100, 1000, 0, 1, None),
        _rec("collection.lockstep", 100, 150, 1, 2, 1),
        _rec("metric.forward", 150, 900, 1, 3, 1),
        _rec("metric.forward_update", 160, 500, 2, 4, 3),
        _rec("metric.compute", 500, 890, 2, 5, 3),
        _rec("metric.sync_state", 600, 800, 3, 6, 5),
        _rec("collection.lockstep", 950, 1000, 1, 7, 1),
        _rec("metric.update", 1100, 1300, 0, 8, None, 8),
        _rec("deferred.dispatch", 1400, 1450, 0, 9, None, 9),
    ]
    for r in records:
        events.append({"ph": "X", "cat": "user_annotation", "name": r.name, "ts": (r.start_ns - 5e9) / 1e3,
                       "dur": (r.end_ns - r.start_ns) / 1e3})
    kernels = [(300, 700), (650, 760), (1200, 1350), (1500, 1600)]
    events += [{"ph": "X", "cat": "kernel", "name": "k", "ts": float(a), "dur": float(b - a)} for a, b in kernels]
    events += [{"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 2000.0, "dur": 10.0},
               {"ph": "i", "cat": "kernel", "name": "instant", "ts": 50.0}]
    return events, records, anchors


def test_idle_attribution_on_a_hand_written_trace():
    events, records, anchors = _hand_trace()
    found = pdevtime.idle_attribution(events, records, anchors, window=(0.0, 1700.0))
    # busy [300, 760] [1200, 1350] [1500, 1600]: idle [0, 300] [760, 1200] [1350, 1500] [1600, 1700]
    want_span = {
        "outside": 100 + 100 + 50 + 50 + 100,  # [0, 100], [1000, 1100], [1350, 1400], [1450, 1500], [1600, 1700]
        "collection.lockstep": 50 + 50,  # [100, 150], [950, 1000]
        "metric.forward": 10 + 10,  # [150, 160], [890, 900]
        "metric.forward_update": 140,  # [160, 300]
        "metric.compute": 90,  # [800, 890]
        "metric.sync_state": 40,  # [760, 800]
        "collection.forward": 50,  # [900, 950]
        "metric.update": 100,  # [1100, 1200]
        "deferred.dispatch": 50,  # [1400, 1450]
    }
    got = found["idle_ms"]["by_span"]
    assert set(got) == set(want_span)
    for name, us in want_span.items():
        assert got[name] == pytest.approx(us / 1e3, abs=1e-9), name
    layers = found["idle_ms"]["by_layer"]
    assert layers == pytest.approx({"outside": 0.4, "runtime": 0.26, "update": 0.24, "sync": 0.04, "other": 0.05},
                                   abs=1e-9)
    assert found["busy_ms"] == pytest.approx(0.71, abs=1e-9) and found["window_ms"] == pytest.approx(1.7)
    assert sum(layers.values()) == pytest.approx(found["window_ms"] - found["busy_ms"], abs=1e-9)
    host = found["host_self_ms"]["by_layer"]
    # runtime: the root's 50 us, the lockstep's 100, metric.forward's 20 and metric.compute's 190
    assert host == pytest.approx({"runtime": 0.36, "update": 0.34 + 0.2, "sync": 0.2, "other": 0.05}, abs=1e-9)
    clock = found["clock"]
    assert clock["drift_us"] == pytest.approx(0.0, abs=1e-6) and clock["joined"] == clock["spans"] == len(records)
    assert clock["join_widest_us"] == pytest.approx(0.0, abs=1e-6)


def test_idle_attribution_window_by_scope_name_and_thread():
    events, records, anchors = _hand_trace()
    events.append({"ph": "X", "cat": "user_annotation", "name": "unit", "ts": 100.0, "dur": 900.0})
    by_name = pdevtime.idle_attribution(events, records, anchors, window="unit")
    assert by_name == pdevtime.idle_attribution(events, records, anchors, window=(100.0, 1000.0))
    assert by_name["window_ms"] == pytest.approx(0.9) and "outside" not in by_name["idle_ms"]["by_span"]
    other = pdevtime.idle_attribution(events, records, anchors, window="unit", thread_id=8)
    assert other["idle_ms"]["by_layer"] == pytest.approx({"outside": 0.9 - other["busy_ms"]})
    with pytest.raises(ValueError, match="no host scope named"):
        pdevtime.idle_attribution(events, records, anchors, window="nope")


def test_idle_attribution_maps_a_drifting_clock():
    """A span clock running 1e-4 slow against the trace's: the two anchors fix the rate."""
    events, records, anchors = _hand_trace()

    def slow(ns):
        return int(5e9 + (ns - 5e9) * (1 - 1e-4))

    records = [r._replace(start_ns=slow(r.start_ns), end_ns=slow(r.end_ns)) for r in records]
    anchors = [tuple(slow(a) for a in reads) for reads in anchors]
    found = pdevtime.idle_attribution(events, records, anchors, window=(0.0, 1700.0))
    assert found["clock"]["drift_us"] == pytest.approx(0.5, abs=1e-3)  # 5,000 us at 1e-4
    assert found["idle_ms"]["by_span"]["metric.forward_update"] == pytest.approx(0.14, abs=1e-6)
    assert found["clock"]["joined"] == len(records)


def test_from_profiler_trace_counts_the_port_only_spans_to_no_phase_of_their_own(tmp_path):
    host = [
        {"ph": "X", "cat": "user_annotation", "name": "metric.forward", "ts": 0, "dur": 900.0},
        {"ph": "X", "cat": "user_annotation", "name": "metric.forward_update", "ts": 10, "dur": 400.0},
        {"ph": "X", "cat": "user_annotation", "name": "collection.forward", "ts": 0, "dur": 1000.0},
        {"ph": "X", "cat": "user_annotation", "name": "collection.lockstep", "ts": 0, "dur": 5.0},
    ]
    (tmp_path / "host").mkdir()
    (tmp_path / "host" / "host.1.trace.json").write_text(json.dumps({"traceEvents": host}))
    assert pdevtime.from_profiler_trace(str(tmp_path / "host")) == {"metric.forward": 0.9}
    # the device track gives the update's kernels to its own scope: they are metric.forward's
    device = host + [
        {"ph": "X", "cat": "gpu_user_annotation", "name": "metric.forward_update", "ts": 20, "dur": 300.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "metric.forward", "ts": 330, "dur": 20.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "collection.forward", "ts": 20, "dur": 330.0},
    ]
    (tmp_path / "device").mkdir()
    (tmp_path / "device" / "host.1.trace.json").write_text(json.dumps({"traceEvents": device}))
    assert pdevtime.from_profiler_trace(str(tmp_path / "device")) == {"metric.forward": pytest.approx(0.32)}


def test_span_ids_are_unique_across_threads():
    pobs.enable(spans=True, counters=False)
    barrier = threading.Barrier(4)

    def work():
        barrier.wait(timeout=10)
        for _ in range(100):
            with pobs.span("outer"):
                with pobs.span("inner"):
                    pass

    threads = [threading.Thread(target=work, daemon=True) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()
    records = pobs.records()
    assert len(records) == 800 and len({r.span_id for r in records}) == 800
    outers = {r.span_id: r for r in records if r.name == "outer"}
    for r in records:
        if r.name == "inner":
            assert outers[r.parent_id].thread_id == r.thread_id and r.root_id == r.parent_id
    assert all(r.root_id == r.span_id for r in outers.values())
