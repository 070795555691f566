"""Per-step forward over a resident validation set.

A step is ``collection(**batch)`` (``dist_sync_on_step`` syncs its delta),
then a host read of the step's values. The loop cycles through the set's
batches in order, from the first, and after the last batch of each pass it
runs ``compute()``, reads the epoch's values and calls ``reset()``: inside the
window, outside any step's time.
"""
from typing import List

from portbench.harness import Ctx, Window, read_values, run_window

UNIT = "step"


def unit(ctx: Ctx, i: int) -> List[tuple]:
    """One step over batch ``i``."""
    with ctx.phase("portbench.forward"):
        out = ctx.collection(**ctx.kwargs(ctx.data["batches"][i]))
    with ctx.phase("portbench.read"):
        return [("step", i, read_values(out))]


def _epoch_end(ctx: Ctx, index: int) -> List[tuple]:
    with ctx.phase("portbench.compute"):
        values = read_values(ctx.collection.compute())
    with ctx.phase("portbench.reset"):
        ctx.collection.reset()
    return [("epoch", index, values)]


def warm(ctx: Ctx) -> None:
    """Two steps of each batch shape the set has, then an epoch's compute and reset."""
    seen = set()
    for i, batch in enumerate(ctx.data["batches"]):
        shape = tuple(batch[ctx.call[next(iter(ctx.call))]].shape)
        if shape not in seen:
            seen.add(shape)
            unit(ctx, i)
            unit(ctx, i)
    _epoch_end(ctx, -1)
    ctx.sync()


def window(ctx: Ctx, seconds: float) -> Window:
    n = len(ctx.data["batches"])

    def after(k: int) -> List[tuple]:
        return _epoch_end(ctx, k // n) if (k + 1) % n == 0 else []

    return run_window(ctx, seconds, UNIT, lambda k: unit(ctx, k % n), after)


def traced_units(ctx: Ctx, count: int) -> List[int]:
    """The steps a traced phase runs: the first ``count`` batches of the set
    that have the first batch's shape (a full batch each)."""
    first = ctx.data["batches"][0]
    key = ctx.call[next(iter(ctx.call))]
    full = [i for i, b in enumerate(ctx.data["batches"]) if b[key].shape == first[key].shape]
    return full[:count]

