"""Host milliseconds of one ``update`` call (its enqueue and its input
checks' reads): the harness's own clock around the call, the mean over the
traced units' updates."""
UNIT = "ms"


def read(rec):
    ms = rec["host_ms"].get("portbench.update")
    return sum(ms) / len(ms) if ms else None
