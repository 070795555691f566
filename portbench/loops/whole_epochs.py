"""Whole evaluation epochs.

An epoch is ``reset()``, one ``update`` for each slice of the rank's rows,
then ``compute()`` with its values read to the host. The window holds whole
epochs; on several ranks every rank runs the same epochs and ``compute()``
gathers their rows.
"""
from typing import List

from portbench.harness import Ctx, Window, read_values, run_window

UNIT = "epoch"


def unit(ctx: Ctx, index: int) -> List[tuple]:
    """One whole epoch."""
    col = ctx.collection
    with ctx.phase("portbench.reset"):
        col.reset()
    for u in ctx.data["updates"]:
        with ctx.phase("portbench.update"):
            col.update(**ctx.kwargs(u))
    with ctx.phase("portbench.compute"):
        values = read_values(col.compute())
    return [("epoch", index, values)]


def warm(ctx: Ctx) -> None:
    """One epoch: every update size and the epoch's compute."""
    unit(ctx, -1)
    ctx.sync()


def window(ctx: Ctx, seconds: float) -> Window:
    return run_window(ctx, seconds, UNIT, lambda k: unit(ctx, k))


def traced_units(ctx: Ctx, count: int) -> List[int]:
    return list(range(count))

