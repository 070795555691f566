"""The traced run: three phases over the same fixed units, after set-up.

1. Counts: the port's spans and counters on, the harness's own host clock
   around each call into the program; the collective calls a unit from the
   port's counters (``record_collective``).
2. Host reads: the synchronizing CUDA calls of a unit, counted with
   ``torch.cuda.set_sync_debug_mode("warn")``.
3. Device: one ``torch.profiler`` session through the port's
   ``observability.start_trace`` (its span tracer then opens a
   ``record_function`` range a span), a warm unit first whose records are not
   read, then the units, each between two CUDA events. The trace is written
   under ``TMPDIR``, read, and deleted.

Every unit's answers join the run's answers and are compared like the timed
window's.
"""
import shutil
import tempfile
import warnings
from typing import Any, Dict, List

import torch

from portbench import trace_reader
from portbench.harness import Ctx, now


class _HostSpans:
    """The harness's host-clock spans: milliseconds by phase name."""

    def __init__(self) -> None:
        self.ms: Dict[str, List[float]] = {}

    def __call__(self, name: str):
        return _HostSpan(self, name)


class _HostSpan:
    def __init__(self, owner: _HostSpans, name: str) -> None:
        self.owner, self.name = owner, name

    def __enter__(self):
        self.t0 = now()
        return self

    def __exit__(self, *exc):
        self.owner.ms.setdefault(self.name, []).append((now() - self.t0) * 1e3)
        return False


def _sync_calls(fn) -> int:
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum(1 for w in caught if "synchroniz" in str(w.message).lower() and "prototype" not in str(w.message))


def traced_run(ctx: Ctx, loop, count: int, groups: Dict[str, List[str]]) -> Dict[str, Any]:
    from metrics_tpu_torch import observability as pobs

    units = loop.traced_units(ctx, count)
    outputs: List[tuple] = []
    cuda = ctx.device.type == "cuda"

    spans = _HostSpans()
    collectives = []
    pobs.enable(spans=True, counters=True)
    pobs.reset()
    ctx.span = spans
    try:
        for i in units:
            before = pobs.counters_snapshot()["collective_calls"]
            outputs += loop.unit(ctx, i)
            collectives.append(pobs.counters_snapshot()["collective_calls"] - before)
    finally:
        ctx.span = None
        pobs.disable()
        pobs.reset()

    host_syncs = []
    if cuda:
        for i in units[:2]:
            host_syncs.append(_sync_calls(lambda: outputs.extend(loop.unit(ctx, i))))

    log_dir = tempfile.mkdtemp(prefix="portbench-trace-")
    events, event_ms, members = [], [], []
    try:
        pobs.enable(spans=True, counters=False)
        pobs.start_trace(log_dir)
        try:
            with torch.profiler.record_function("portbench.warm"):
                outputs += loop.unit(ctx, units[0])
            ctx.sync()
            pobs.reset()
            ctx.span = torch.profiler.record_function
            marks = []
            for i in units:
                pair = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) if cuda else None
                if pair:
                    pair[0].record()
                with torch.profiler.record_function("portbench.unit"):
                    outputs += loop.unit(ctx, i)
                if pair:
                    pair[1].record()
                    marks.append(pair)
            ctx.sync()
        finally:
            ctx.span = None
            members = [r.attrs.get("metric") for r in sorted(pobs.records(), key=lambda r: r.start_ns)
                       if r.name == "metric.forward" and r.attrs]
            path = pobs.stop_trace()
            pobs.disable()
            pobs.reset()
        event_ms = [a.elapsed_time(b) for a, b in marks] if marks else None
        events = trace_reader.load(path)
    finally:
        shutil.rmtree(log_dir, ignore_errors=True)
    ctx.collection.reset()  # drop what the traced phases accumulated
    return {
        "outputs": outputs,
        "unit": loop.UNIT,
        "units": len(units),
        "host_ms": spans.ms,
        "collectives": collectives,
        "host_syncs": host_syncs if cuda else None,
        "trace": trace_reader.summarize(events, members, groups, event_ms) if cuda else None,
    }
