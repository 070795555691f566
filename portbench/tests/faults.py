"""Runs of a cell on the CPU with the program broken underneath the harness,
for the tests that see ``correct`` come out false. Each fault is a patch of
the port that the run then drives unknowingly."""
import argparse
import contextlib

import torch

from portbench import discover, run

SEED = 4_000_000_007
MIN_UNITS = 4  # two passes of the image rehearsal's two batches


def _patched(obj, name, make):
    old = getattr(obj, name)
    setattr(obj, name, make(old))
    return old


@contextlib.contextmanager
def fault(name: str):
    """The port with fault ``name`` planted, undone on exit."""
    from metrics_tpu_torch.core import collections as colmod
    from metrics_tpu_torch.core import metric as metmod

    undo = []

    def patch(obj, attr, make):
        undo.append((obj, attr, _patched(obj, attr, make)))

    if name == "state_unchanged":  # a step or an update leaves the accumulated state as it was
        patch(metmod.Metric, "merge_states", lambda old: lambda self, a, b: a)
        patch(colmod.MetricCollection, "update", lambda old: _every_other(old))
    elif name == "half_batch":  # half of each batch left out; the means are taken over the rest
        patch(colmod.MetricCollection, "forward", lambda old: lambda self, **kw: old(self, **_half(kw)))
        patch(colmod.MetricCollection, "update", lambda old: lambda self, **kw: old(self, **_half(kw)))
    elif name == "answer_altered":  # the first value of each answer altered where it is produced
        patch(colmod.MetricCollection, "forward", lambda old: lambda self, **kw: _nudged(old(self, **kw)))
        patch(colmod.MetricCollection, "compute", lambda old: lambda self: _nudged(old(self)))
    elif name == "no_exchange":  # every rank's gather returns its own rows in each peer's place
        patch(torch.distributed, "all_gather", lambda old: _local_gather)
    elif name != "none":
        raise ValueError(name)
    try:
        yield
    finally:
        for obj, attr, old in reversed(undo):
            setattr(obj, attr, old)


def _every_other(update):
    calls = [0]

    def wrapped(self, **kw):
        calls[0] += 1
        if calls[0] % 2:
            update(self, **kw)

    return wrapped


def _half(kw):
    return {k: v[: max(1, len(v) // 2)] for k, v in kw.items()}


def _nudged(out):
    out = dict(out)
    first = next(iter(out))
    out[first] = out[first] + 1e-2
    return out


def _local_gather(outs, value, group=None, async_op=False):
    for o in outs:
        o.copy_(value)
    return None


def run_cell(workload: str, fault_name: str = "none", rank: int = 0, addr: str = "", seconds: float = 1.0,
             trace: int = 0):
    """One rank of a CPU run of ``workload`` (a cell of BENCHMARK.json or a staged one) at its rehearsal
    sizes, with ``fault_name`` planted; rank 0 returns the result line (a dict)."""
    bench = discover.with_staged(discover.benchmark())
    cell = discover.cell(bench, workload)
    args = argparse.Namespace(workload=workload, seed=SEED, seconds=seconds, trace=trace, rank=rank, addr=addr,
                              device="cpu")
    with fault(fault_name), _at_least(MIN_UNITS):
        return run.run_rank(args, bench, cell, rank, addr or f"127.0.0.1:{run._free_port()}")


@contextlib.contextmanager
def _at_least(units: int):
    """The window closes no earlier than after ``units`` units, however slow a loaded CPU makes them: a
    fault that only an epoch's answer shows needs a whole pass in the window."""
    from portbench.harness import Ctx

    stop = Ctx.stop
    seen = [0]

    def patient(self, local):
        seen[0] += 1
        return stop(self, local and seen[0] >= units)

    Ctx.stop = patient
    try:
        yield
    finally:
        Ctx.stop = stop


def rank_main(workload, fault_name, rank, addr, queue):
    """A spawned rank of a several-rank CPU run; rank 0 puts its line (or the error) on ``queue``."""
    try:
        line = run_cell(workload, fault_name, rank, addr)
        if rank == 0:
            queue.put(line)
    except Exception as e:  # the test reports it
        queue.put({"error": repr(e)})
        raise
