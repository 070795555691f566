"""Reads a ``torch.profiler`` Chrome trace into what the per-layer metrics need.

The traced phase wraps each unit (a step or an epoch) in a host range named
``portbench.unit`` and each call into the program in a ``portbench.<phase>``
range; the port's span tracer opens a ``metric.forward`` range around each
member's forward while a profiler session runs. Each unit ends with a host
read of its values, so every device operation it enqueued starts and ends
inside its host range: a device operation belongs to the unit whose host
range holds its start. A kernel belongs to a member when the host call that
launched it (the runtime event of the same ``correlation``) lies inside that
member's ``metric.forward`` range; the ranges are matched to the member names
the span tracer recorded, in order.

Device operations are kernels, copies and memsets. A unit's busy time is the
union of their intervals; a profiler can drop a kernel's record, so units
whose operation count is below the most any unit has are left out of the
device metrics and named in ``notes``.
"""
import bisect
import json
from typing import Any, Dict, List, Optional, Sequence

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def load(path: str) -> List[Dict[str, Any]]:
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _merged(intervals: List[tuple]) -> List[tuple]:
    out: List[list] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def _innermost_at(ranges: List[tuple], times: List[float]) -> List[Optional[str]]:
    """For each of the sorted ``times``, the name of the shortest range
    ``(start, end, name)`` holding it, or None: one sweep over the ranges'
    edges, with the ranges open at each time in hand."""
    edges = sorted([(s, 0, i) for i, (s, _, _) in enumerate(ranges)] + [(e, 2, i) for i, (_, e, _) in enumerate(ranges)]
                   + [(t, 1, j) for j, t in enumerate(times)])
    open_: Dict[int, float] = {}
    out: List[Optional[str]] = [None] * len(times)
    for _, kind, i in edges:  # at equal times: starts, then the times, then ends (a range holds its edges)
        if kind == 0:
            open_[i] = ranges[i][1] - ranges[i][0]
        elif kind == 2:
            open_.pop(i, None)
        elif open_:
            out[i] = ranges[min(open_, key=open_.get)][2]
    return out


def summarize(events: Sequence[Dict[str, Any]], members: Sequence[str] = (),
              groups: Optional[Dict[str, Sequence[str]]] = None,
              event_ms: Optional[Sequence[float]] = None) -> Dict[str, Any]:
    """Per-unit device time, by operation name and by member group, the
    window's busy share, and the breakdown of the result line.

    ``members``: the ``metric.forward`` spans' member names, in order, over
    the measured units. ``groups``: group name -> member names. ``event_ms``:
    each unit's CUDA-event time, against which its busy time is checked."""
    groups = groups or {}
    ops, launches, annotations = [], {}, []
    for ev in events:
        if ev.get("ph") != "X" or not isinstance(ev.get("dur"), (int, float)):
            continue
        cat, ts, dur = ev.get("cat"), float(ev["ts"]), float(ev["dur"])
        corr = (ev.get("args") or {}).get("correlation")
        if cat in DEVICE_CATS:
            ops.append((ts, ts + dur, ev.get("name", "?"), corr))
        elif cat in LAUNCH_CATS and corr is not None:
            launches[corr] = ts
        elif cat == "user_annotation":
            annotations.append((ts, ts + dur, ev.get("name", "")))
    units = sorted((s, e) for s, e, n in annotations if n == "portbench.unit")
    notes: List[str] = []
    if not units:
        return {"units": [], "notes": ["no portbench.unit range in the trace"]}
    starts = [s for s, _ in units]
    per = [{"ops": [], "by_name": {}, "groups": {g: 0.0 for g in groups}} for _ in units]
    for op in ops:
        k = bisect.bisect_right(starts, op[0]) - 1
        if k >= 0 and op[0] <= units[k][1]:
            per[k]["ops"].append(op)

    forwards = sorted((s, e) for s, e, n in annotations
                      if n == "metric.forward" and any(us <= s <= ue for us, ue in units))
    member_of_group = {m: g for g, ms in groups.items() for m in ms}
    attributed = bool(groups) and len(forwards) == len(members)
    if groups and not attributed:
        notes.append(f"{len(forwards)} metric.forward ranges in the trace against {len(members)} spans recorded:"
                     " member groups not attributed")
    fstarts = [s for s, _ in forwards]
    unattributed = 0
    for u in per:
        for s, e, name, corr in u["ops"]:
            u["by_name"][name] = u["by_name"].get(name, 0.0) + (e - s) / 1e3
            if not attributed:
                continue
            launch = launches.get(corr)
            if launch is None:
                unattributed += 1
                continue
            j = bisect.bisect_right(fstarts, launch) - 1
            if j >= 0 and launch <= forwards[j][1]:
                g = member_of_group.get(members[j])
                if g is not None:
                    u["groups"][g] += (e - s) / 1e3
    if unattributed:
        notes.append(f"{unattributed} device operations without a launch event: left out of the member groups")

    counts = [len(u["ops"]) for u in per]
    full = max(counts)
    complete = [i for i, c in enumerate(counts) if c == full and c > 0]
    if len(complete) < len(per):
        notes.append(f"device operations a unit {counts}: the profiler dropped records; units {complete} kept")
    rows = []
    for i in complete:
        u, (s, e) = per[i], units[i]
        busy = sum(b - a for a, b in _merged([(a, b) for a, b, _, _ in u["ops"]])) / 1e3
        row = {"ops": len(u["ops"]), "busy_ms": busy, "span_ms": (e - s) / 1e3, "by_name": u["by_name"],
               "groups": dict(u["groups"]) if attributed else {}}
        if event_ms is not None:
            row["event_ms"] = float(event_ms[i])
            if busy > row["event_ms"] * 1.05 + 0.02:
                notes.append(f"unit {i}: profiled busy {busy:.3f} ms exceeds its CUDA-event time {row['event_ms']:.3f} ms")
        rows.append(row)

    w0, w1 = units[0][0], units[-1][1]
    busy_iv = _merged([(max(a, w0), min(b, w1)) for u in per for a, b, _, _ in u["ops"] if b > w0 and a < w1])
    busy_s = sum(b - a for a, b in busy_iv) / 1e6
    gaps: Dict[str, float] = {}
    harness = [(s, e, n) for s, e, n in annotations if n.startswith("portbench.") and w0 <= s <= w1]
    edges = [w0] + [x for iv in busy_iv for x in iv] + [w1]
    cuts = sorted({x for s, e, _ in harness for x in (s, e)})
    pieces = []
    for a, b in zip(edges[0::2], edges[1::2]):
        # each piece of an idle gap is named by the innermost harness range the host was in
        inner = cuts[bisect.bisect_right(cuts, a):bisect.bisect_left(cuts, b)]
        pieces += [(lo, hi) for lo, hi in zip([a] + inner, inner + [b]) if hi > lo]
    for (lo, hi), name in zip(pieces, _innermost_at(harness, [(lo + hi) / 2 for lo, hi in pieces])):
        name = name or "portbench.between_units"
        gaps[name] = gaps.get(name, 0.0) + (hi - lo) / 1e6
    by_name: Dict[str, float] = {}
    for u in per:
        for name, ms in u["by_name"].items():
            by_name[name] = by_name.get(name, 0.0) + ms / 1e3
    return {
        "units": rows,
        "window_s": (w1 - w0) / 1e6,
        "busy_s": busy_s,
        "device_ops": sorted(([n, s] for n, s in by_name.items()), key=lambda x: -x[1])[:10],
        "idle_gaps": sorted(([n, s] for n, s in gaps.items()), key=lambda x: -x[1])[:10],
        "notes": notes,
    }


def unit_mean_ms(trace, match) -> Optional[float]:
    """Mean over the kept units of the device ms of operations whose name
    ``match`` accepts; None where no unit has one."""
    if not trace or not trace.get("units"):
        return None
    per = [sum(ms for name, ms in u["by_name"].items() if match(name.lower())) for u in trace["units"]]
    return sum(per) / len(per) if any(per) else None
