"""Milliseconds a step: the whole window over the steps completed in it. The
window also holds each pass's ``compute()`` and ``reset()``."""
UNIT = "ms"


def read(rec):
    if rec["unit"] != "step" or not rec["units"]:
        return None
    return rec["window_s"] * 1e3 / rec["units"]
