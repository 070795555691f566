"""Share of the profiled units' window (first start to last end) in which no
operation ran on rank 0's card: the union of kernel, copy and memset
intervals."""
UNIT = "%"


def read(rec):
    t = rec["trace"]
    if not t or not t.get("units") or t["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
