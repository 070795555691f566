"""Host milliseconds of an epoch's ``compute()`` through its values' read
(which waits for the card): the harness's own clock, the mean over the traced
epochs."""
UNIT = "ms"


def read(rec):
    ms = rec["host_ms"].get("portbench.compute")
    return sum(ms) / len(ms) if ms else None
