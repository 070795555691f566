"""Timing helpers for the port's kernels on a CUDA card.

Every function here needs a CUDA device and raises without one (``torch.cuda``
calls fail); nothing falls back to the CPU. Times are milliseconds or
microseconds of this run on the card the caller names beside them.
"""
import statistics
import time
from typing import Callable, Dict, List

import torch


def device_ms_cold(fn: Callable[[], object], reps: int, flush: torch.Tensor) -> float:
    """Median milliseconds of ``fn`` on the card, one CUDA-event pair per call.

    Before each call ``flush`` (larger than the 50 MB L2 cache) is zeroed, so the
    inputs come from device memory as a fresh batch does, and the card is kept
    busy with a spin so that the start event fires after the host has enqueued
    the call: the pair times the device work alone, not the host's enqueue.
    """
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(2_000_000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def ms_back_to_back(fn: Callable[[], object], calls: int) -> float:
    """Milliseconds per call over ``calls`` calls between one event pair (L2 warm, host overhead included)."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def host_enqueue_us(fn: Callable[[], object], calls: int = 200, chunk: int = 50,
                    sleep_cycles: int = 100_000_000) -> float:
    """Host microseconds per call to enqueue ``fn``, with the device held busy.

    The card spins (``torch.cuda._sleep``) while the host clock runs around
    ``chunk`` calls, so the host never waits on the device; chunks keep the
    stream's queue of pending work short. Raises if the spin ended before the
    host finished, since the clock would then include device time.
    """
    total = 0.0
    for _ in range(calls // chunk):
        torch.cuda.synchronize()
        torch.cuda._sleep(sleep_cycles)
        t0 = time.perf_counter()
        for _ in range(chunk):
            fn()
        total += time.perf_counter() - t0
        marker = torch.cuda.Event()
        marker.record()
        if marker.query():
            raise AssertionError("the device went idle before the host finished enqueuing; raise sleep_cycles")
    torch.cuda.synchronize()
    return total / (calls // chunk * chunk) * 1e6


def device_breakdown(fn: Callable[[], object], calls: int = 20) -> List[Dict[str, object]]:
    """Device operations of one call of ``fn``, from ``torch.profiler`` over ``calls`` calls.

    Returns one row per device operation name (kernel, memset or copy):
    ``{"name", "per_call", "us_per_call"}``, where ``per_call`` is how many times
    it ran per call of ``fn`` and ``us_per_call`` its device microseconds per
    call of ``fn``. Raises when the trace holds no device time.

    The session takes a warm-up step of one call first, whose events it drops:
    a kernel launched just after a session starts can go unrecorded (one of 20
    did on the card once), which would read as a fraction of a launch a call.
    """
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
        fn()
        torch.cuda.synchronize()
        prof.step()  # the warm-up step ends; the measured step begins
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        prof.step()
    rows = [
        {"name": e.key, "per_call": e.count / calls, "us_per_call": e.self_device_time_total / calls}
        for e in prof.key_averages()
        # the schedule's own ``ProfilerStep#`` range is no device operation of ``fn``
        if e.device_type == torch.autograd.DeviceType.CUDA and e.count > 0 and not e.key.startswith("ProfilerStep")
    ]
    if not rows or sum(r["us_per_call"] for r in rows) <= 0:
        raise AssertionError("torch.profiler recorded no device time on this machine")
    return sorted(rows, key=lambda r: -r["us_per_call"])
