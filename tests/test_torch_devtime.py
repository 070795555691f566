"""Device-time attribution and compile telemetry of the port, against the JAX package.

* ``enable(device_time=True)`` fences every phase: the phase spans of a
  collection loop carry ``device_ms``, and on CPU tensors the fence
  synchronizes no stream and never initializes CUDA.
* ``device_time_table`` has the JAX package's rows and columns for the same
  ``MetricCollection([Accuracy, F1])`` loop (the JAX package in its eager
  form), and ``PHASE_OF_SPAN`` is its mapping.
* ``from_profiler_trace`` reads a real CPU ``torch.profiler`` session over an
  annotated update (the spans' ``record_function`` scopes and ``annotate``),
  takes the device annotation events over the host ones on a hand-written
  trace (no double count), and gives ``{}`` for a missing directory.
* Compile telemetry: a fake kernel build through the loader's counting hook
  (``ops.build.LOAD_HOOK``) counts a miss, a library found built counts a
  hit, and the spans they land in carry ``compiled=yes`` where the others
  carry ``compiled=no``.

Tolerances: names, rows, columns and counts are equal; times are only
checked to be present and non-negative.
"""
import ctypes.util
import json
import time
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu as mt
import metrics_tpu.observability as jobs
import metrics_tpu_torch as pt
import metrics_tpu_torch.observability as pobs
from metrics_tpu.core import metric as jmetric
from metrics_tpu.observability import devtime as jdevtime
from metrics_tpu_torch.observability import devtime as pdevtime
from metrics_tpu_torch.ops import build as pbuild
from tests.test_torch_faults import plane_hygiene  # noqa: F401  (autouse: every test leaves the process clean)
from tests.test_torch_observability import obs_hygiene  # noqa: F401  (autouse: observability off and empty)

torch.set_num_threads(1)
CPU = {"device": "cpu"}


def _probs(rng, n, c):
    p = rng.random((n, c))
    return (p / p.sum(1, keepdims=True)).astype(np.float32)


def _loop(package, obs, steps=3):
    rng = np.random.default_rng(5)
    if package is pt:
        col = pt.MetricCollection([pt.Accuracy(**CPU), pt.F1(num_classes=4, average="macro", **CPU)])
    else:
        col = mt.MetricCollection([mt.Accuracy(), mt.F1(num_classes=4, average="macro")])
    obs.enable(device_time=True)
    try:
        for _ in range(steps):
            p, t = _probs(rng, 32, 4), rng.integers(0, 4, 32)
            if package is pt:
                col(torch.from_numpy(p), torch.from_numpy(t))
            else:
                col(jnp.asarray(p), jnp.asarray(t.astype(np.int32)))
        col.compute()
        return obs.records(), obs.device_time_table()
    finally:
        obs.disable()
        obs.reset()


def test_fence_stamps_device_ms_and_leaves_cuda_alone(monkeypatch):
    def no_stream(*_a, **_k):
        raise AssertionError("the fence synchronized a stream for CPU tensors")

    monkeypatch.setattr(torch.cuda, "current_stream", no_stream)
    records, _table = _loop(pt, pobs)
    phases = [r for r in records if r.name in pdevtime.PHASE_OF_SPAN]
    assert phases and all(r.attrs["device_ms"] >= 0.0 for r in phases)
    assert not torch.cuda.is_initialized()
    # disabled: a no-op, no attr
    pobs.enable()
    with pobs.span("phase") as sp:
        pdevtime.fence(torch.zeros(3))
    assert "device_ms" not in (sp.attrs or {})


def test_fence_charges_the_innermost_open_span():
    pobs.enable(device_time=True)
    with pobs.span("outer"):
        with pobs.span("inner"):
            pdevtime.fence({"a": [torch.zeros(2)], "b": (torch.ones(1),)})
    outer, inner = pobs.records()
    assert "device_ms" in inner.attrs and not (outer.attrs or {}).get("device_ms")


def test_device_time_table_rows_and_columns_equal_jax():
    old = jmetric.set_default_jit(False)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            _, table = _loop(pt, pobs)
            _, jtable = _loop(mt, jobs)
    finally:
        jmetric.set_default_jit(old)
    assert {row: sorted(cols) for row, cols in table.items()} == {row: sorted(cols) for row, cols in jtable.items()}
    assert sorted(table) == ["Accuracy", "F1", "collection"]
    assert pdevtime.PHASE_OF_SPAN == jdevtime.PHASE_OF_SPAN


def test_group_rows_carry_update_and_sync_columns():
    def gather(x):
        return [x, x]

    rng = np.random.default_rng(2)
    col = pt.MetricCollection([pt.Accuracy(**CPU), pt.F1(num_classes=4, average="macro", **CPU),
                               pt.Precision(num_classes=4, average="macro", **CPU)])
    for m in col.values():
        m.dist_sync_fn, m.dist_sync_on_step = gather, True
    pobs.enable(device_time=True)
    for _ in range(2):
        col(torch.from_numpy(_probs(rng, 16, 4)), torch.from_numpy(rng.integers(0, 4, 16)))
    table = pobs.device_time_table()
    assert {"update", "sync", "compute"} <= set(table["F1"])  # the group: collection.group_update / step_sync
    assert {"forward", "sync", "compute"} <= set(table["Accuracy"])  # a singleton group: its own forward


def test_from_profiler_trace_on_a_cpu_session(tmp_path):
    pobs.enable()
    m = pt.Accuracy(**CPU)
    pobs.start_trace(str(tmp_path / "prof"))
    try:
        for _ in range(2):
            m.update(torch.tensor([1, 0, 1]), torch.tensor([1, 1, 1]))
        with pobs.annotate("metric.sync"):
            torch.ones(8).sum()
    finally:
        path = pobs.stop_trace()
    assert Path(path).name.endswith(".trace.json") and Path(path).parent == tmp_path / "prof"
    totals = pobs.devtime.from_profiler_trace(str(tmp_path / "prof"))
    assert totals["metric.update"] > 0.0 and totals["metric.sync"] > 0.0
    events = json.loads(Path(path).read_text())["traceEvents"]
    assert sum(1 for e in events if e.get("name") == "metric.update" and e.get("ph") == "X") == 2


def test_from_profiler_trace_takes_device_events_over_host_events(tmp_path):
    events = [
        {"ph": "X", "cat": "user_annotation", "name": "metric.update", "ts": 0, "dur": 900.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "metric.update", "ts": 10, "dur": 250.0},
        {"ph": "X", "cat": "user_annotation", "name": "metric.update", "ts": 2000, "dur": 700.0},
        {"ph": "X", "cat": "gpu_user_annotation", "name": "metric.update", "ts": 2010, "dur": 150.0},
        {"ph": "X", "cat": "user_annotation", "name": "metric.compute", "ts": 3000, "dur": 300.0},
        {"ph": "X", "cat": "user_annotation", "name": "sharded.engine.ring", "ts": 4000, "dur": 100.0},
        {"ph": "X", "cat": "kernel", "name": "binned_counts_kernel", "ts": 15, "dur": 200.0},
        {"ph": "i", "name": "metric.update", "ts": 0},
    ]
    (tmp_path / "host.1.trace.json").write_text(json.dumps({"traceEvents": events}))
    (tmp_path / "ignored.json").write_text("not a trace")
    totals = pdevtime.from_profiler_trace(str(tmp_path))
    assert totals == {"metric.update": 0.4, "metric.compute": 0.3, "sharded.engine": 0.1}


def test_from_profiler_trace_missing_dir_is_empty(tmp_path):
    assert pdevtime.from_profiler_trace(str(tmp_path / "nope")) == {}
    assert jdevtime.from_profiler_trace(str(tmp_path / "nope")) == {}


# ---------------------------------------------------------- compile telemetry
def _fake_library(monkeypatch, built: bool) -> pbuild.KernelLibraries:
    """A loader whose build returns the C library, as if ``nvcc`` had just run
    (``built``) or found it in the build directory."""
    libs = pbuild.KernelLibraries()

    def fake_build(name, force=False):
        time.sleep(0.002)
        return Path(ctypes.util.find_library("c") or "libc.so.6"), built

    monkeypatch.setattr(libs, "_build", fake_build)
    return libs


def test_compile_probe_stamps_the_span_a_build_lands_in(monkeypatch):
    pobs.enable(compile_events=True)
    assert pbuild.LOAD_HOOK is not None
    miss, hit = _fake_library(monkeypatch, built=True), _fake_library(monkeypatch, built=False)
    with pobs.span("metric.update"):
        miss.load("fake_kernel")
    with pobs.span("metric.update"):
        miss.load("fake_kernel")  # loaded once a process: no event
    with pobs.span("metric.compute"):
        hit.load("fake_kernel")
    first, second, third = pobs.records()
    assert first.attrs["compiled"] == "yes" and first.attrs["compile_ms"] > 0.0
    assert second.attrs == {"compiled": "no"}
    assert third.attrs["compiled"] == "yes"
    snap = pobs.compile_snapshot()
    assert snap["compile_events"] == 2 and snap["compile_cache"] == {"hits": 1, "misses": 1}
    assert snap["backend_compile_ms"] > 0.0 and snap["trace_ms"] == 0.0 and snap["lowering_ms"] == 0.0
    assert pobs.summarize()["metric.update"]["compile_ms"] == first.attrs["compile_ms"]


def test_compile_telemetry_off_leaves_spans_and_loader_alone(monkeypatch):
    pobs.enable(compile_events=True)
    pobs.disable()
    assert pbuild.LOAD_HOOK is None
    pobs.enable()
    libs = _fake_library(monkeypatch, built=True)
    with pobs.span("metric.update"):
        libs.load("fake_kernel")
    (rec,) = pobs.records()
    assert rec.attrs is None
    assert pobs.compile_snapshot()["compile_events"] == 0


@pytest.mark.parametrize("level", [None, 2])
def test_start_trace_twice_raises_and_stop_without_start_raises(tmp_path, level):
    pobs.start_trace(str(tmp_path), host_tracer_level=level)
    try:
        with pytest.raises(RuntimeError, match="running already"):
            pobs.start_trace(str(tmp_path))
    finally:
        pobs.stop_trace()
    with pytest.raises(RuntimeError, match="no profiler session"):
        pobs.stop_trace()
