"""Collective calls a unit (a step or an epoch), from the port's counters
(``record_collective`` in ``parallel/sync.py``), the mean over the traced
units."""
UNIT = "calls"


def read(rec):
    c = rec["collectives"]
    return sum(c) / len(c) if c else None
