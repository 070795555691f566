"""Counterpart of ``metrics_tpu/observability/export.py``, copied: the same
columns, event schema and flow events.

Exports: span aggregates, JSON-lines, and Chrome-trace/Perfetto files.

Three consumers, three formats:

- ``summarize()``: an in-process aggregate table keyed by span name
  (count / total / mean / min / max ms).
- ``write_jsonl()``: one self-describing JSON object per line (``span`` lines,
  then ``summary`` lines, then one ``counters`` line) — grep/jq-friendly,
  append-safe.
- ``chrome_trace()`` / ``write_chrome_trace()``: the Chrome ``trace_events``
  JSON-object format (https://docs.google.com/document/d/1CvAClvFfyA5R-PhYUmn5OOQtYMH4h6I0nSsKchNAySU)
  that ``chrome://tracing`` and https://ui.perfetto.dev load directly. Spans
  become complete (``"ph": "X"``) events on their thread's track; the
  collective counters ride in ``otherData``. Spans stamped a ``flow`` attr
  (the publish path's window flow id — see
  :mod:`~metrics_tpu_torch.observability.lifecycle`) additionally emit Chrome flow
  events (``ph: "s"/"t"/"f"``), so Perfetto draws ingest -> publish -> merge
  arrows ACROSS threads — causality the thread-local parent links cannot
  express once the deferred host plane or the merge tier takes over.
"""
import json
import threading
import time
from typing import Any, Dict, List, Optional

from metrics_tpu_torch.observability import counters as _counters
from metrics_tpu_torch.observability import trace as _trace
from metrics_tpu_torch.observability.trace import SpanRecord

__all__ = ["summarize", "to_trace_events", "chrome_trace", "write_chrome_trace", "write_jsonl"]


def summarize(records: Optional[List[SpanRecord]] = None) -> Dict[str, Dict[str, Any]]:
    """Aggregate spans by name: {name: {count, total_ms, mean_ms, min_ms,
    max_ms, compile_ms, device_ms, state_bytes, e2e_ms, flow_id}}.

    ``compile_ms`` sums the kernel build time stamped by
    :mod:`~metrics_tpu_torch.observability.compilemon`; ``device_ms`` sums the
    fenced device waits stamped by
    :mod:`~metrics_tpu_torch.observability.devtime`; ``state_bytes`` is the
    LARGEST per-metric state footprint stamped on the span's update/sync
    records (a gauge, so max — not sum — is the meaningful aggregate; the
    per-metric breakdown lives in the counters snapshot). ``e2e_ms`` is the
    worst end-to-end close -> publish latency stamped by the lifecycle
    ledger on the serving runtime's ``service.publish`` spans, and ``flow_id`` the highest flow id
    seen — both max-aggregated gauges like ``state_bytes``. All columns are
    always present (0 when the corresponding monitor never ran) so the
    table schema is stable; the hot path is untouched — the attrs are
    stamped at span close only while those monitors are enabled, and this
    aggregation runs post-hoc.
    """
    if records is None:
        records = _trace.records()
    table: Dict[str, Dict[str, Any]] = {}
    for rec in records:
        ms = rec.duration_ms
        attrs = rec.attrs or {}
        row = table.get(rec.name)
        if row is None:
            row = table[rec.name] = {
                "count": 1, "total_ms": ms, "min_ms": ms, "max_ms": ms,
                "compile_ms": 0.0, "device_ms": 0.0, "state_bytes": 0,
                "e2e_ms": 0.0, "flow_id": 0,
            }
        else:
            row["count"] += 1
            row["total_ms"] += ms
            row["min_ms"] = min(row["min_ms"], ms)
            row["max_ms"] = max(row["max_ms"], ms)
        row["compile_ms"] += attrs.get("compile_ms", 0.0)
        row["device_ms"] += attrs.get("device_ms", 0.0)
        row["state_bytes"] = max(row["state_bytes"], attrs.get("state_bytes", 0))
        row["e2e_ms"] = max(row["e2e_ms"], float(attrs.get("e2e_ms", 0.0)))
        flow = attrs.get("flow")
        if flow is not None:
            # merge-tier spans carry the LIST of contributing shard flows
            fids = flow if isinstance(flow, (list, tuple)) else (flow,)
            if fids:
                row["flow_id"] = max(row["flow_id"], max(int(f) for f in fids))
    for row in table.values():
        row["mean_ms"] = row["total_ms"] / row["count"]
    return table


def _epoch_us(ns: int) -> float:
    """Map a perf_counter_ns stamp onto the wall-clock epoch, in microseconds."""
    wall_ns, mono_ns = _trace.TRACE.epoch_anchor
    return (wall_ns + (ns - mono_ns)) / 1e3


def _flow_events(records: List[SpanRecord]) -> List[Dict[str, Any]]:
    """Chrome flow events joining spans that share a ``flow`` attr.

    Each flow id emits a start (``ph: "s"``) on its earliest span, steps
    (``"t"``) on the middle ones and a finish (``"f"``, binding point
    ``"e"`` = enclosing slice) on the latest — Perfetto then draws the
    arrow chain across thread tracks. A merge-tier span whose ``flow`` is a
    LIST joins every contributing shard's flow. Flows seen on only one span
    are skipped: an arrow needs two ends.
    """
    by_flow: Dict[int, List[SpanRecord]] = {}
    for rec in records:
        flow = (rec.attrs or {}).get("flow")
        if flow is None:
            continue
        for fid in flow if isinstance(flow, (list, tuple)) else (flow,):
            by_flow.setdefault(int(fid), []).append(rec)
    events: List[Dict[str, Any]] = []
    for fid in sorted(by_flow):
        chain = sorted(by_flow[fid], key=lambda r: r.start_ns)
        if len(chain) < 2:
            continue
        for pos, rec in enumerate(chain):
            event: Dict[str, Any] = {
                "name": "publish_flow",
                "cat": "metrics_tpu.flow",
                "id": fid,
                "ph": "s" if pos == 0 else ("f" if pos == len(chain) - 1 else "t"),
                "ts": _epoch_us(rec.start_ns),
                "pid": 0,
                "tid": rec.thread_id,
            }
            if event["ph"] == "f":
                event["bp"] = "e"
            events.append(event)
    return events


def to_trace_events(records: Optional[List[SpanRecord]] = None) -> List[Dict[str, Any]]:
    """Spans as Chrome ``trace_events`` complete events (``ph: 'X'``), plus
    flow events (``'s'/'t'/'f'``) for spans stamped a ``flow`` attr."""
    if records is None:
        records = _trace.records()
    events: List[Dict[str, Any]] = []
    threads_seen = set()
    for rec in records:
        if rec.thread_id not in threads_seen:
            threads_seen.add(rec.thread_id)
            events.append(
                {
                    "name": "thread_name",
                    "ph": "M",
                    "pid": 0,
                    "tid": rec.thread_id,
                    "args": {
                        "name": "main"
                        if rec.thread_id == threading.main_thread().ident
                        else f"thread-{rec.thread_id}"
                    },
                }
            )
        event: Dict[str, Any] = {
            "name": rec.name,
            "ph": "X",
            "ts": _epoch_us(rec.start_ns),
            "dur": (rec.end_ns - rec.start_ns) / 1e3,
            "pid": 0,
            "tid": rec.thread_id,
        }
        args: Dict[str, Any] = {}
        if rec.parent is not None:
            args["parent"] = rec.parent
        if rec.attrs:
            args.update(rec.attrs)
        if args:
            event["args"] = args
        events.append(event)
    events.extend(_flow_events(records))
    return events


def chrome_trace(
    records: Optional[List[SpanRecord]] = None,
    include_counters: bool = True,
    counters: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    """The full Chrome-trace JSON object (Perfetto-loadable).

    ``counters`` overrides the live snapshot in ``otherData`` — callers that
    reset the counters per measured phase (bench A/Bs) pass the snapshot of
    the phase of record instead of whatever the last reset left behind.
    """
    out: Dict[str, Any] = {
        "traceEvents": to_trace_events(records),
        "displayTimeUnit": "ms",
    }
    if include_counters:
        out["otherData"] = _counters.snapshot() if counters is None else dict(counters)
    return out


def write_chrome_trace(
    path: str,
    records: Optional[List[SpanRecord]] = None,
    include_counters: bool = True,
    counters: Optional[Dict[str, Any]] = None,
) -> None:
    """Write a ``.json`` trace loadable by chrome://tracing / ui.perfetto.dev."""
    with open(path, "w") as f:
        json.dump(chrome_trace(records, include_counters=include_counters, counters=counters), f)


def write_jsonl(path: str, records: Optional[List[SpanRecord]] = None) -> None:
    """JSON-lines dump: per-span lines, per-name summary lines, counters line.

    Line schema (the ``type`` field discriminates):
      {"type": "span", "name", "start_us", "dur_ms", "tid", "depth", "parent", "attrs"}
      {"type": "summary", "name", "count", "total_ms", "mean_ms", "min_ms", "max_ms"}
      {"type": "counters", "collective_calls", "sync_bytes", ...}
    """
    if records is None:
        records = _trace.records()
    with open(path, "w") as f:
        for rec in records:
            f.write(
                json.dumps(
                    {
                        "type": "span",
                        "name": rec.name,
                        "start_us": _epoch_us(rec.start_ns),
                        "dur_ms": rec.duration_ms,
                        "tid": rec.thread_id,
                        "depth": rec.depth,
                        "parent": rec.parent,
                        "attrs": rec.attrs,
                    }
                )
                + "\n"
            )
        for name, row in sorted(summarize(records).items()):
            f.write(json.dumps({"type": "summary", "name": name, **row}) + "\n")
        f.write(
            json.dumps({"type": "counters", "exported_at": time.time(), **_counters.snapshot()}) + "\n"
        )
